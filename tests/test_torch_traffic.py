"""Serving traffic and the carbon-aware QPS router in the port against the
JAX reference (the reference's tests/test_traffic.py, run through all
three of the port's drivers):

- ``plan_traffic`` byte-equal to the reference's, ``traffic_graph_key``
  and ``validate_qps_weights`` alike;
- the M/M/c model (``erlang_c``, ``mmc_p99``, ``mmc_p50``,
  ``lambda_caps``) bit-equal; ``modeled_p99`` equal in f64, within f32
  rounding on torch;
- ``route_epoch`` with numpy, torch one lane and torch batched equal to
  the reference's numpy and jnp paths, on seeded and edge-case lanes;
- the host loop, the scanned driver and the ensemble against the
  reference's host loop: request counters exact, placements equal,
  request gCO2 to rel 1e-4 and the modeled p99 to rel 1e-3 (the host
  loops' f64 values equal);
- the zero-QPS golden digests, the loud-traffic invariance, conservation
  and the tenant request bins, and a (SLO x greenness) grid in one
  bucket."""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_faults import BASE, GOLDEN, MIXED, assert_same, digest
from test_torch_reference import jnp, load_reference, ref_sim_config

from repro_torch.core import router as R
from repro_torch.core import simulator as S
from repro_torch.core.faults import FaultConfig
from repro_torch.core.traffic import (REQ_CAP, TrafficConfig, plan_traffic,
                                      traffic_graph_key,
                                      validate_qps_weights)

TRAFFIC = TrafficConfig(req_rate=20000.0, n_svc=4, flash_rate=0.05,
                        mu_per_chip=0.1)
# the reference's saturated stream: ~75 % chip occupancy puts serving
# replicas across carbon classes, so the blend redistributes load
DENSE = S.SimConfig(epochs=24, seed=3, arrival_rate=16.0,
                    mean_duration_h=10.0, shortlist=16, history_h=48,
                    horizon_h=8, chips_lo=8, chips_hi=32)
REQ_COUNTERS = ("req_served", "req_offered", "p99_violations")


def with_traffic(cfg, tcfg=TRAFFIC, **pol):
    policy = dataclasses.replace(cfg.policy, **pol) if pol else cfg.policy
    return dataclasses.replace(cfg, traffic=tcfg, policy=policy)


def assert_requests(got, want, *, exact=False):
    """Request counters exact; request gCO2 to rel 1e-4 and the modeled
    p99 to rel 1e-3 (the reference's host-vs-scan bars), or equal."""
    for f in REQ_COUNTERS:
        assert getattr(got, f) == getattr(want, f), f
    if exact:
        assert got.req_gco2 == want.req_gco2
        assert got.req_p99_s == want.req_p99_s
    else:
        assert got.req_gco2 == pytest.approx(want.req_gco2, rel=1e-4)
        assert got.req_p99_s == pytest.approx(want.req_p99_s, rel=1e-3)


def drivers(cfg, n=96, chips=64, jobs=None):
    """(port host loop, port scan, port one-lane ensemble, reference host
    loop) on one stream."""
    ref = load_reference()
    f, t, r = S.synthetic_lifecycle_fleet(n, cfg, chips_per_node=chips,
                                          device="cpu")
    fr, tr, rr = ref.simulator.synthetic_lifecycle_fleet(
        n, ref_sim_config(cfg), chips_per_node=chips)
    jobs = jobs if jobs is not None else S.generate_jobs(cfg)
    jr = ref.simulator.JobSchedule(**dataclasses.asdict(jobs))
    host = S.simulate_fleet(f, t, r, cfg, jobs=jobs)
    scan = S.simulate_fleet_scan(f, t, r, cfg, jobs=jobs)
    ens = S.simulate_fleet_ensemble([(f, t, r, cfg, jobs)])[0]
    want = ref.simulator.simulate_fleet(fr, tr, rr, ref_sim_config(cfg),
                                        jobs=jr)
    return host, scan, ens, want


# ---------------------------------------------------------------------------
# the plan, the graph key, the weight check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tcfg,epochs,sim_seed", [
    (TrafficConfig(), 24, 0),
    (TRAFFIC, 24, 3),
    (TrafficConfig(req_rate=500.0, flash_rate=0.1, noise_sigma=0.2), 48, 7),
    (TrafficConfig(seed=5, req_rate=900.0, diurnal_amp=0.0, n_svc=2), 36, 2),
    (TrafficConfig(req_rate=0.0, flash_rate=0.5, noise_sigma=1.0), 64, 3),
    (TrafficConfig(req_rate=40000.0, flash_rate=0.6, flash_len_h=6,
                   flash_mult=4.0, noise_sigma=0.3), 96, 11)],
    ids=["default", "probe", "noisy", "flat", "zero", "flash_cap"])
def test_plan_traffic_byte_equal_to_reference(tcfg, epochs, sim_seed):
    ref = load_reference()
    got = plan_traffic(tcfg, epochs, sim_seed)
    want = ref.traffic.plan_traffic(
        ref.traffic.TrafficConfig(**dataclasses.asdict(tcfg)), epochs,
        sim_seed)
    assert got.req.dtype == want.req.dtype == np.int32
    np.testing.assert_array_equal(got.req, want.req)
    np.testing.assert_array_equal(got.rate, want.rate)
    assert got.req.min() >= 0 and got.req.max() <= REQ_CAP
    if tcfg.req_rate == 0.0:
        assert int(got.req.sum()) == 0
    if tcfg.flash_mult == 4.0:
        assert int(got.req.max()) == REQ_CAP     # the flash crowds hit it


def test_graph_key_and_weight_check_match_reference():
    ref = load_reference()
    cfgs = [None, TrafficConfig(req_rate=100.0, n_svc=3),
            TrafficConfig(req_rate=9999.0, n_svc=3, flash_rate=0.4,
                          serve_frac=0.9, mu_per_chip=7.0),
            TrafficConfig(n_svc=0)]
    for c in cfgs:
        rc = None if c is None else \
            ref.traffic.TrafficConfig(**dataclasses.asdict(c))
        assert traffic_graph_key(c) == ref.traffic.traffic_graph_key(rc)
    assert traffic_graph_key(cfgs[1]) == traffic_graph_key(cfgs[2]) == 3
    for w in (None, np.full(40000, 1, np.int32), np.full(32767, 1, np.int32),
              np.ones(8, np.int32)):
        outcome = []
        for fn in (validate_qps_weights, ref.traffic.validate_qps_weights):
            try:
                fn(w)
                outcome.append("ok")
            except ValueError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]
    for bad in (dict(req_rate=-1.0), dict(flash_rate=1.5), dict(n_svc=-1),
                dict(weight_hi=0), dict(mu_per_chip=0.0)):
        with pytest.raises(ValueError):
            TrafficConfig(**bad)


# ---------------------------------------------------------------------------
# the M/M/c model
# ---------------------------------------------------------------------------


def test_mmc_model_bit_equal_to_reference():
    ref = load_reference()
    rng = np.random.default_rng(5)
    c = rng.integers(0, 65, 256)
    mu = 0.1
    lam = rng.random(256) * c * mu * 1.1
    for fn in ("mmc_p99", "mmc_p50"):
        np.testing.assert_array_equal(getattr(R, fn)(c, mu, lam),
                                      getattr(ref.router, fn)(c, mu, lam))
    np.testing.assert_array_equal(R.erlang_c(c, lam / mu),
                                  ref.router.erlang_c(c, lam / mu))
    for c_max, mu, slo in ((32, 0.1, 12.0), (64, 0.1, 10.5), (16, 1.0, 0.5),
                           (8, 2.0, 0.75), (64, 0.05, 200.0)):
        got = R.lambda_caps(c_max, mu, slo)
        np.testing.assert_array_equal(
            got, ref.router.lambda_caps(c_max, mu, slo))
        assert got.dtype == np.int32 and got.shape == (c_max + 1,)
        # each entry is bisected on its own: a wider table keeps the prefix
        np.testing.assert_array_equal(R.lambda_caps(c_max + 24, mu,
                                                    slo)[:c_max + 1], got)


def test_modeled_p99_matches_reference():
    ref = load_reference()
    rng = np.random.default_rng(6)
    chips = rng.integers(0, 33, 512)
    routed = rng.integers(0, 40000, 512)
    want = ref.router.modeled_p99(np, routed, chips, 32, 0.1)
    np.testing.assert_array_equal(R.modeled_p99(np, routed, chips, 32, 0.1),
                                  want)
    got = R.modeled_p99(torch, torch.from_numpy(routed).reshape(8, 64),
                        torch.from_numpy(chips).reshape(8, 64), 32,
                        torch.full((8, 1), 0.1))
    want_j = np.asarray(ref.router.modeled_p99(
        jnp(), jnp().asarray(routed), jnp().asarray(chips), 32,
        jnp().float32(0.1)))
    np.testing.assert_allclose(got.numpy().ravel(), want, rtol=1e-3)
    np.testing.assert_allclose(got.numpy().ravel(), want_j, rtol=1e-5)


# ---------------------------------------------------------------------------
# route_epoch: numpy, torch one lane, torch batched vs the reference
# ---------------------------------------------------------------------------


def _lanes(rng, L, n_svc, *, kind="seeded"):
    """One epoch's lanes (svc, jid, weight, cap, carbon)."""
    svc = np.where(rng.random(L) < 0.75, rng.integers(0, n_svc, L),
                   -1).astype(np.int32)
    jid = rng.permutation(4 * L)[:L].astype(np.int32)
    w = rng.integers(1, 5, L).astype(np.int32)
    cap = rng.integers(0, 3000, L).astype(np.int32)
    # few distinct carbon keys: many ties broken by the job id
    carbon = (rng.integers(0, 4, L) * np.float32(97.25)).astype(np.float32)
    if kind == "idle":
        svc[:] = -1
    elif kind == "infeasible":
        cap[:] = 0
    elif kind == "overload":
        cap = rng.integers(0, 40, L).astype(np.int32)
    elif kind == "first_ties":
        # several services carry weight, so the remainder's first-service
        # mask has several Trues; odd weights leave a floor remainder
        svc = (np.arange(L) % n_svc).astype(np.int32)
        w = np.full(L, 3, np.int32)
    return dict(svc=svc, jid=jid, weight=w, cap=cap, carbon=carbon)


CASES = [(k, n_svc, g) for k in ("seeded", "idle", "infeasible",
                                 "overload", "first_ties")
         for n_svc in (1, 4) for g in (0.0, 0.5, 1.0)]


@pytest.mark.parametrize("kind,n_svc,g", CASES,
                         ids=[f"{k}-svc{n}-g{g:g}" for k, n, g in CASES])
def test_route_epoch_matches_reference_numpy_and_jnp(kind, n_svc, g):
    ref = load_reference()
    J = jnp()
    rng = np.random.default_rng([ord(ch) for ch in kind] + [n_svc])
    L = 24
    lanes = _lanes(rng, L, n_svc, kind=kind)
    req = np.int32(rng.integers(1, REQ_CAP) if kind != "overload"
                   else 60001)
    kw = dict(lanes, req_t=req, n_svc=n_svc, greenness=np.float32(g))
    want = ref.router.route_epoch(np, **kw)
    want_j = ref.router.route_epoch(
        J, **{k: J.asarray(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()})
    for a, b in zip(want, want_j):
        np.testing.assert_array_equal(a, np.asarray(b))
    got_np = R.route_epoch(np, **kw)
    got_t = R.route_epoch(torch, **{
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    for got in (got_np, got_t):
        np.testing.assert_array_equal(np.asarray(got[0]), want[0])
        np.testing.assert_array_equal(np.asarray(got[1]), want[1])
        assert np.asarray(got[0]).dtype == np.int32
    routed, offered = want
    if kind == "idle":
        assert int(routed.sum()) == int(offered.sum()) == 0
    else:
        # conservation: every offered request lands on some replica
        assert int(routed.sum()) == int(offered[:n_svc].sum()) == int(req)


def test_route_epoch_batched_lanes_equal_one_lane_calls():
    """The (L, S) form routes each lane with its own request count,
    greenness and capacities, exactly as one-lane calls do; the rows mix
    every edge case and the empty slots of a scan (jid -1, many times)."""
    ref = load_reference()
    rng = np.random.default_rng(9)
    n_svc, S_ = 4, 40
    rows = []
    for i, kind in enumerate(["seeded", "idle", "infeasible", "overload",
                              "first_ties", "seeded", "seeded", "overload"]):
        lanes = _lanes(rng, S_, n_svc, kind=kind)
        empty = rng.random(S_) < 0.3
        lanes["svc"][empty] = -1
        lanes["jid"][empty] = -1
        lanes["weight"][empty] = 0
        lanes["cap"][empty] = 0
        rows.append(dict(lanes, req_t=np.int32(rng.integers(0, REQ_CAP)),
                         greenness=np.float32([0.0, 0.25, 0.5, 0.75, 1.0,
                                               0.3, 1.0, 0.5][i])))
    stack = {k: torch.from_numpy(np.stack([r[k] for r in rows]))
             for k in rows[0]}
    routed, offered = R.route_epoch_batched(n_svc=n_svc, **stack)
    assert routed.dtype == offered.dtype == torch.int32
    for i, row in enumerate(rows):
        want = ref.router.route_epoch(np, n_svc=n_svc, **row)
        np.testing.assert_array_equal(routed[i].numpy(), want[0])
        np.testing.assert_array_equal(offered[i].numpy(), want[1])


def test_route_epoch_reference_examples():
    """The reference's hand-made route_epoch cases, through the batched
    torch form."""
    def route(req, svc, w, cap, carbon, n_svc, g):
        L = len(svc)
        r, o = R.route_epoch(
            torch, req_t=req, svc=torch.tensor(svc, dtype=torch.int32),
            jid=torch.arange(L, dtype=torch.int32),
            weight=torch.tensor(w, dtype=torch.int32),
            cap=torch.tensor(cap, dtype=torch.int32),
            carbon=torch.tensor(carbon, dtype=torch.float32), n_svc=n_svc,
            greenness=g)
        return r.tolist(), o.tolist()

    c4 = [1.0, 2.0, 3.0, 4.0]
    assert route(200, [0] * 4, [1] * 4, [100] * 4, c4, 1, 0.0) == \
        ([50, 50, 50, 50], [200, 0])
    assert route(200, [0] * 4, [1] * 4, [100] * 4, c4, 1, 1.0)[0] == \
        [100, 100, 0, 0]
    r, _ = route(200, [0] * 4, [1] * 4, [100] * 4, c4, 1, 0.5)
    assert sum(r) == 200 and max(r) <= 100
    assert route(100, [0] * 3, [1] * 3, [0, 10, 10], c4[:3], 1, 1.0)[0] == \
        [0, 90, 10]
    assert route(800, [0, 0, 1, 1], [3, 3, 1, 1], [10**6] * 4, [1.0] * 4, 2,
                 1.0)[1] == [600, 200, 0]
    assert route(500, [-1] * 3, [0] * 3, [0] * 3, [0.0] * 3, 2, 1.0) == \
        ([0, 0, 0], [0, 0, 0])


# ---------------------------------------------------------------------------
# the serving columns of the job schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    with_traffic(DENSE), with_traffic(dataclasses.replace(DENSE,
                                                          n_tenants=3)),
    with_traffic(MIXED, TrafficConfig(n_svc=2, serve_frac=0.9,
                                      weight_hi=7)),
    dataclasses.replace(BASE, traffic=TrafficConfig(n_svc=0))],
    ids=["dense", "tenants", "mixed", "no_services"])
def test_generate_jobs_serving_columns_match_reference(cfg):
    ref = load_reference()
    got = S.generate_jobs(cfg)
    want = ref.simulator.generate_jobs(ref_sim_config(cfg))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None:
            assert a is None, f.name
        else:
            assert a.dtype == np.asarray(b).dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    # the serving columns draw last: every earlier column is the
    # traffic-free draw's
    plain = S.generate_jobs(dataclasses.replace(cfg, traffic=None))
    for f in ("arrive", "chips", "duration", "deferrable", "tenant"):
        a, b = getattr(got, f), getattr(plain, f)
        assert (a is None and b is None) or np.array_equal(a, b), f


# ---------------------------------------------------------------------------
# the three drivers against the reference's host loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["base", "mixed", "dense", "faults"])
def test_traffic_drivers_match_reference(name):
    """Request counters and routing decisions exact across the port's host
    loop, scan and ensemble and the reference's host loop; under faults
    the decisions read the observed CI, the accounting the true one."""
    cfg = {"base": BASE, "mixed": MIXED, "dense": DENSE,
           "faults": dataclasses.replace(MIXED, faults=FaultConfig(
               ci_dropout=0.2, telem_sigma=0.1))}[name]
    pol = {} if name == "faults" else dict(router_slo_s=12.0,
                                           router_greenness=0.75)
    host, scan, ens, want = drivers(with_traffic(cfg, **pol))
    assert want.req_served > 0
    assert_same(host, want, emissions_rel=0)
    assert_requests(host, want, exact=True)
    for r in (scan, ens):
        assert_same(r, host)
        assert_requests(r, host)
    if name in ("base", "mixed"):
        assert digest(host) == GOLDEN[name]


@pytest.mark.parametrize("name", ["base", "mixed"])
def test_zero_qps_reproduces_golden_digests(name):
    """A configured but silent traffic layer leaves every driver's
    placements on the golden trajectory, with all request counters 0."""
    cfg = {"base": BASE, "mixed": MIXED}[name]
    host, scan, ens, want = drivers(with_traffic(
        cfg, TrafficConfig(req_rate=0.0, n_svc=2)))
    for r in (host, scan, ens, want):
        assert digest(r) == GOLDEN[name]
        assert r.req_served == r.req_offered == r.p99_violations == 0
        assert r.req_gco2 == 0.0
    f, t, ri = S.synthetic_lifecycle_fleet(96, cfg, chips_per_node=64,
                                           device="cpu")
    quiet = S.simulate_fleet(f, t, ri, cfg)
    assert_same(host, quiet, emissions_rel=0)


def test_loud_traffic_leaves_placements_invariant():
    """The router never feeds back into placement."""
    host, scan, ens, _ = drivers(with_traffic(BASE))
    for r in (host, scan, ens):
        assert digest(r) == GOLDEN["base"]
        assert r.req_served > 0


def test_request_conservation_and_tenant_bins():
    cfg = with_traffic(dataclasses.replace(DENSE, n_tenants=3),
                       router_slo_s=12.0, router_greenness=1.0)
    host, scan, ens, want = drivers(cfg, n=48)
    tplan = plan_traffic(cfg.traffic, cfg.epochs, cfg.seed)
    assert host.req_served == host.req_offered == int(tplan.req.sum())
    np.testing.assert_array_equal(host.tenant_request_g,
                                  want.tenant_request_g)
    for r in (host, scan, ens):
        assert r.tenant_request_g.shape == (4,)
        assert r.tenant_request_g[-1] == 0.0   # the spare bin stays 0
        np.testing.assert_allclose(r.tenant_request_g.sum(), r.req_gco2,
                                   rtol=1e-5)
        np.testing.assert_allclose(r.tenant_request_g, host.tenant_request_g,
                                   rtol=1e-4)
    # request carbon is an attribution slice, never added to emissions
    f, t, ri = S.synthetic_lifecycle_fleet(48, cfg, chips_per_node=64,
                                           device="cpu")
    base = S.simulate_fleet(f, t, ri, dataclasses.replace(cfg, traffic=None))
    assert host.emissions_g == base.emissions_g


def test_slo_greenness_grid_is_one_bucket_equal_to_solo_scans():
    f, t, ri = S.synthetic_lifecycle_fleet(48, DENSE, chips_per_node=64,
                                           device="cpu")
    runs, keys = [], set()
    for slo in (10.5, 12.0, 18.0):
        for g in (0.0, 0.5, 1.0):
            cfg = with_traffic(DENSE, router_slo_s=slo, router_greenness=g)
            runs.append((f, t, ri, cfg))
            keys.add(S._bucket_key(S._prepare_scan_run(f, t, ri, cfg,
                                                       pad_plan=True)))
    assert len(keys) == 1
    res = S.simulate_fleet_ensemble(runs)
    for spec, r in zip(runs, res):
        solo = S.simulate_fleet_scan(*spec, pad_plan=True)
        assert_same(r, solo, emissions_rel=0)
        assert_requests(r, solo, exact=True)
    gpr = {c.policy.router_greenness: r.req_gco2 / max(r.req_served, 1)
           for (_, _, _, c), r in zip(runs, res)
           if c.policy.router_slo_s == 12.0}
    assert gpr[1.0] < gpr[0.5] < gpr[0.0]
