"""The port's batched ensemble vs the JAX reference:
``simulate_fleet_ensemble`` lane by lane against the reference's ensemble (placements, start epochs and
the nine counters exact, emissions to rel 1e-4, the golden digests),
``place_lifecycle_batched`` against the reference's batched engine, and
``sweep_policies`` / ``pareto_frontier`` records against the reference's."""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from test_torch_reference import jnp, load_reference, reference_imports
from test_torch_scan import BASE, MIXED, assert_same, cfgs

from repro_torch.core import placement as P
from repro_torch.core import simulator as S
from repro_torch.core.energy import EnergyModel
from repro_torch.core.fleet import FIELDS, Fleet
from repro_torch.core.policy import PolicyConfig

GOLDEN = ["0141b64da0651227", "0e6437d00c3ba558"]


def _specs(kws, n=96, chips=64):
    """(port runs, reference runs) for the same configurations."""
    ref = load_reference()
    port, want = [], []
    for kw in kws:
        cp, cr = cfgs(**kw)
        f, t, r = S.synthetic_lifecycle_fleet(n, cp, chips_per_node=chips,
                                              device="cpu")
        port.append((f, t, r, cp, S.generate_jobs(cp)))
        fr, tr, rr = ref.simulator.synthetic_lifecycle_fleet(
            n, cr, chips_per_node=chips)
        want.append((fr, tr, rr, cr, ref.simulator.generate_jobs(cr)))
    return port, want


def _ref_ensemble(runs):
    with reference_imports():
        return load_reference().simulator.simulate_fleet_ensemble(runs)


def _digest(r):
    return hashlib.sha256(np.concatenate(
        [r.node_log, r.first_node]).tobytes()).hexdigest()[:16]


def test_ensemble_golden_digests():
    """The reference's golden trajectories (BASE, MIXED) through the
    port's ensemble lanes."""
    port, _ = _specs([BASE, MIXED])
    assert [_digest(r) for r in S.simulate_fleet_ensemble(port)] == GOLDEN


def test_reactive_seed_ensemble_matches_reference_lanes():
    """One bucket: the mixed stream (arrivals, releases, migrations,
    deferrals, outage evictions) over three seeds."""
    kws = [dict(MIXED, seed=s, deferrable_frac=0.5) for s in (11, 12, 13)]
    port, want = _specs(kws)
    got = S.simulate_fleet_ensemble(port)
    for a, b in zip(got, _ref_ensemble(want)):
        assert_same(a, b)
    for a, (f, t, r, c, j) in zip(got, port):
        assert_same(a, S.simulate_fleet_scan(f, t, r, c, jobs=j,
                                             pad_plan=True), emissions_rel=0)
    assert sum(r.jobs_deferred for r in got) > 0


def test_ragged_multi_bucket_call_keeps_order():
    """Members with other arrival rates stack into padded buckets; members
    with other epochs or knobs land in other buckets; results come back in
    input order, each equal to the reference's lane."""
    kws = [BASE, dict(MIXED, deferrable_frac=0.5), dict(BASE, seed=4),
           dict(BASE, epochs=12), dict(BASE, seed=1, arrival_rate=2.0),
           dict(BASE, seed=2, arrival_rate=17.0)]
    port, want = _specs(kws)
    got = S.simulate_fleet_ensemble(port)
    assert [len(r.node_log) for r in got] == [s[4].n for s in port]
    for a, b in zip(got, _ref_ensemble(want)):
        assert_same(a, b)
    buckets = {S._bucket_key(S._prepare_scan_run(*s, pad_plan=True))
               for s in port}
    assert len(buckets) == 3


def test_kernel_lanes_match_reference_and_the_port_drivers():
    """``use_kernel=True`` lanes (the reference bench's kernel leg, n =
    2048, E = 2): the port's plain K3/K4 twins against the reference's
    Pallas kernels in interpret mode, and against the port's per-lane scan
    and host loop with the sequential K2 twin."""
    kw = dict(epochs=12, arrival_rate=6.0, mean_duration_h=6.0,
              shortlist=16, history_h=48, horizon_h=8, use_kernel=True)
    port, want = _specs([dict(kw, seed=s) for s in (0, 1)], n=2048)
    got = S.simulate_fleet_ensemble(port)
    for a, b in zip(got, _ref_ensemble(want)):
        assert_same(a, b)
    for a, (f, t, r, c, j) in zip(got, port):
        assert_same(a, S.simulate_fleet_scan(f, t, r, c, jobs=j,
                                             pad_plan=True), emissions_rel=0)
        assert_same(a, S.simulate_fleet(f, t, r, c, jobs=j))
    assert [r.rank_sweeps for r in got] == [13, 12]


def test_threshold_grid_is_one_bucket_and_still_bites():
    cfg = dict(BASE, deferrable_frac=1.0)
    kws = [dict(cfg, policy=PolicyConfig(defer_green_factor=f))
           for f in (0.0, 0.95, 100.0)]
    ref = load_reference()
    port, want = [], []
    for kw in kws:
        cp = S.SimConfig(**kw)
        cr = ref.simulator.SimConfig(**dict(kw, policy=ref.policy.PolicyConfig(
            defer_green_factor=kw["policy"].defer_green_factor)))
        f, t, r = S.synthetic_lifecycle_fleet(96, cp, chips_per_node=64,
                                              device="cpu")
        port.append((f, t, r, cp, S.generate_jobs(cp)))
        fr, tr, rr = ref.simulator.synthetic_lifecycle_fleet(
            96, cr, chips_per_node=64)
        want.append((fr, tr, rr, cr, ref.simulator.generate_jobs(cr)))
    assert len({S._bucket_key(S._prepare_scan_run(*s, pad_plan=True))
                for s in port}) == 1
    got = S.simulate_fleet_ensemble(port)
    for a, b in zip(got, _ref_ensemble(want)):
        assert_same(a, b)
    assert got[0].jobs_deferred == 0 < got[2].jobs_deferred


def _lane_fleets(ref, n, seeds):
    fr = [ref.fleet.synthetic_fleet(n, seed=s) for s in seeds]
    stacked = {f: np.stack([np.asarray(getattr(x, f)) for x in fr])
               for f in FIELDS}
    port = Fleet(**{f: torch.from_numpy(v) for f, v in stacked.items()})
    return port, ref.fleet.Fleet(**{f: jnp().asarray(v)
                                    for f, v in stacked.items()})


@pytest.mark.parametrize("engine,use_kernel", [
    ("shortlist", False), ("shortlist", True), ("full", False),
    ("full", True)])
def test_place_lifecycle_batched_matches_reference(engine, use_kernel):
    """Three lanes with their own marginal-weight energy models, their own
    starting capacity and event counts (one lane empty): node (L, E),
    capacity and sweeps exact."""
    ref = load_reference()
    L, n, E = 3, 1500, 24
    fp, fr = _lane_fleets(ref, n, (1, 2, 3))
    rng = np.random.default_rng(5)
    dem = rng.integers(8, 96, (L, E)).astype(np.int32)
    n_ev = np.array([E, 15, 0], np.int32)
    dem[1, 15:] = dem[2] = 0
    cap = np.minimum(np.asarray(fr.capacity) + rng.integers(0, 9, (L, n)),
                     np.asarray(fr.chips_total)).astype(np.int32)
    models = [EnergyModel(idle_frac=0.25, embodied_g_per_node_h=90.0),
              EnergyModel(), EnergyModel(idle_frac=0.4)]
    wm = (0.2, 0.0, 0.5)
    em_p = [m.device(w_marginal=w, device="cpu") for m, w in zip(models, wm)]
    em_r = [ref.energy.EnergyModel(
        idle_frac=m.idle_frac, embodied_g_per_node_h=m.embodied_g_per_node_h
    ).device(w_marginal=w) for m, w in zip(models, wm)]
    em_r = ref.energy.EnergyModel(**{
        k: jnp().stack([getattr(e, k) for e in em_r])
        for k in ("idle_frac", "chip_power_w", "host_power_w",
                  "embodied_g_per_node_h", "w_marginal", "dyn_frac")})
    node, cap_out, sweeps = P.place_lifecycle_batched(
        fp, torch.from_numpy(dem), engine=engine, shortlist=8,
        use_kernel=use_kernel, capacity=torch.from_numpy(cap),
        n_events=torch.from_numpy(n_ev), energy=em_p)
    with reference_imports():
        node_r, cap_r, sweeps_r = ref.placement.place_lifecycle_batched(
            fr, jnp().asarray(dem), engine=engine, shortlist=8,
            use_kernel=use_kernel, capacity=jnp().asarray(cap),
            n_events=jnp().asarray(n_ev), energy=em_r)
    np.testing.assert_array_equal(node.numpy(), np.asarray(node_r))
    np.testing.assert_array_equal(cap_out.numpy(), np.asarray(cap_r))
    np.testing.assert_array_equal(sweeps.numpy(), np.asarray(sweeps_r))
    assert int(sweeps[2]) == 0 and bool((node[2] == -1).all())
    # and each lane is the sequential engine's run on that lane
    for l in range(L):
        lane = Fleet(**{f: getattr(fp, f)[l] for f in FIELDS})
        kw = dict(capacity=torch.from_numpy(cap[l]), n_events=int(n_ev[l]),
                  energy=em_p[l])
        if engine == "full":
            r = P.place_lifecycle_full_rerank(lane, dem[l], -np.ones(E), **kw)
        else:
            r = P.place_lifecycle_shortlist(lane, dem[l], -np.ones(E),
                                            shortlist=8, eager_sweep=True,
                                            use_kernel=use_kernel, **kw)
        np.testing.assert_array_equal(node[l].numpy(), r.node.numpy())
        assert int(sweeps[l]) == r.n_sweeps


def test_sweep_policies_and_pareto_frontier_match_reference():
    """A reactive defer_green_factor grid over two seeds in one
    single-region bucket: the records' counters exact and their emissions
    to rel 1e-4 against the reference's; the frontier picks the same
    points; the port's ensemble and sequential sweeps agree exactly."""
    ref = load_reference()
    kw = dict(epochs=12, seed=0, arrival_rate=4.0, mean_duration_h=3.0,
              deferrable_frac=0.5, defer_max_h=4, history_h=24,
              horizon_h=6, shortlist=8)
    factors = {"g0": 0.0, "g85": 0.85, "g95": 0.95, "g150": 1.5}
    grid = {k: PolicyConfig(defer_green_factor=f) for k, f in
            factors.items()}
    grid_r = {k: ref.policy.PolicyConfig(defer_green_factor=f)
              for k, f in factors.items()}
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
    fa = S.pareto_frontier(a)
    fb = ref.simulator.pareto_frontier(want)
    assert [p["policy"] for p in fa] == [p["policy"] for p in fb]
    for p, q in zip(fa, fb):
        assert p["avg_start_delay_h"] == q["avg_start_delay_h"]
        assert p["emissions_g"] == pytest.approx(q["emissions_g"], rel=1e-4)
    ys = [p["emissions_g"] for p in fa]
    assert ys == sorted(ys, reverse=True) and len(set(ys)) == len(ys)
    assert sum(r["deferred"] for r in a) > 0


@pytest.mark.parametrize("what", ["shard", "shard_en", "blind"])
def test_unported_ensemble_options_raise(what):
    """The host-only comparators refuse.  ``shard=True`` without a process
    group is the unsharded program: it refuses nothing and equals the
    plain ensemble bit for bit (its split over ranks runs in
    ``tests/test_torch_multirank.py``).  ``shard="en"`` over a world of
    two ranks no longer refuses: the lane's placement engine splits over
    the two by nodes and the lane, and ``sweep_policies``' result, equal
    the one-process run bit for bit on both ranks."""
    cp = S.SimConfig(**dict(BASE, epochs=4))
    f, t, r = S.synthetic_lifecycle_fleet(16, cp, device="cpu")
    if what == "shard":
        assert not torch.distributed.is_initialized()
        plain = S.simulate_fleet_ensemble([(f, t, r, cp)])
        for a, b in zip(plain, S.simulate_fleet_ensemble([(f, t, r, cp)],
                                                         shard=True)):
            assert_same(b, a, emissions_rel=0)
        return
    if what == "shard_en":
        import _multirank_ranks as R
        from repro_torch.distributed.ranks import run_ranks
        chips = 64
        f, t, r = S.synthetic_lifecycle_fleet(16, cp, chips_per_node=chips,
                                              device="cpu")
        want = S.simulate_fleet_ensemble([(f, t, r, cp,
                                           S.generate_jobs(cp))])
        sweep = S.sweep_policies(cp, {"r": PolicyConfig()}, n=16,
                                 device="cpu")
        out = run_ranks(R.world_tasks, 2, [
            ("en", "ensemble_en", dict(cfgs=[cp], n=16, chips=chips)),
            ("sweep", "sweep_en", dict(cfg=cp, n=16))], timeout=240)
        for got in out:
            for a, b in zip(got["en"], want):
                assert_same(a, b, emissions_rel=0)
            assert got["sweep"] == sweep
        return
    cp = dataclasses.replace(cp, engine="blind")
    with pytest.raises(ValueError, match="scanned core"):
        S.simulate_fleet_ensemble([(f, t, r, cp)])


@pytest.mark.parametrize("shard", [True, "e", "en"])
def test_ensemble_shard_on_one_device_is_the_unsharded_program(shard):
    """The reference's single-device case (tests/test_simulator_ensemble.py
    ``test_ensemble_shard_en_single_device_is_noop``): on one device any
    ``shard`` runs the unsharded program, bit for bit, through the
    ensemble and ``sweep_policies`` (both of its paths)."""
    port, _ = _specs([BASE, dict(BASE, seed=4)])
    plain = S.simulate_fleet_ensemble(port)
    sharded = S.simulate_fleet_ensemble(port, shard=shard)
    for a, b in zip(plain, sharded):
        assert_same(b, a, emissions_rel=0)
    kw = dict(epochs=6, history_h=24, horizon_h=6, shortlist=8,
              arrival_rate=4.0)
    grid = {"r": PolicyConfig()}
    args = dict(n=16, seeds=(0, 1), chips_per_node=64, device="cpu")
    want = S.sweep_policies(S.SimConfig(**kw), grid, **args)
    assert S.sweep_policies(S.SimConfig(**kw), grid, shard=shard,
                            **args) == want
    assert S.sweep_policies(S.SimConfig(**kw), grid, shard=shard,
                            ensemble=False, **args) == want
