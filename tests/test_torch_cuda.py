"""The port's CUDA kernels on the card: K1/K2 and the batched K3/K4
bitwise equal to their plain torch twins (on the same card, and on the
CPU), each K3/K4 lane equal to K1/K2 on that lane, and the placement
engines' and the ensemble's kernel paths equal to their CPU paths; the
sorted tile top-k at every k up to the cap (128), with exact ties, zero
scores and tiles with fewer than k finite scores, and the merged
shortlist through tile candidates equal to the full-vector merge; the
carbon policies, signal faults and tenant attribution on the card equal to
the CPU (the chaos probe, SLO streams, planner lanes); the batched QPS
router, the serving probe and a (SLO x greenness) serving grid on the card
equal to the CPU; K5
(bf16 on the tensor cores, f32 on the FMA pipes) and K6 within the JAX
suite's bars of their plain versions, edge cases included (S 1 and 2048,
GQA groups, padded head dims, windows, large logits, long and short scan
memory, element-wise staging), K5 at the moonshot, qwen2-vl and zamba2
prefill shapes, K6's per-head form (Mamba-2, N 16 and 64; per channel,
zamba2's heads, ragged tiles) and its (D, N) form bitwise, and one
full-width moonshot MoE layer giving the
same bits on two runs; the training path (no kernel): train
steps of every reduced training family (granite, falcon, danube, moonshot
and phi3.5 at capacity factor 16, zamba2 through the scan and SSD routes,
qwen2-vl on the stub frontend's embeddings) with f32 parameters on the
card equal to the CPU, their bf16 gradients bit for bit on two card runs
and under ``torch.use_deterministic_algorithms``, and the launcher's fault
restart on the card equal to its clean run; K5/K6's custom ops equal to their bare launches bit
for bit, and reduced prefill and decode steps counted on the card
(``launch.step_cost``) equal to the meta dry run; the serving engine's
captured steps (CUDA graphs) equal to the eager steps bit for bit for
every served family, reduced, in bf16 and f32 (prefill logits and caches,
8 decode steps), and K5/K6's launch counts after captured prefills equal
to the warm-ups' launches plus the captured launches times the replays;
decode attention at the two served shapes reading the bf16 cache in place
(its scores, outputs and the memory one call takes).
Skips without a GPU;
run on the card with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import fleet as fleetlib
from repro_torch.core import placement as P
from repro_torch.core import simulator as S
from repro_torch.core.ranking import RankWeights
from repro_torch.kernels import maizx_rank as mr
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda

W4 = [0.35, 0.25, 0.25, 0.15]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _streams(n, seed, dev, marginal, ties=False):
    g = np.random.default_rng(seed)
    s = [g.random(n) * 100, 1 + g.random(n), g.random(n) * 500,
         g.random(n) * 500, g.random(n), g.random(n)]
    if ties:                          # duplicate the first tile everywhere
        s = [np.resize(x[:1024], n) for x in s]
    s = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in s]
    kw = {}
    if marginal:
        ct = g.choice([64.0, 96.0, 128.0], n).astype(np.float32)
        cap = np.where(g.random(n) < 0.3, ct, np.floor(g.random(n) * ct))
        kw = dict(pk=torch.from_numpy((g.random(n) * 8).astype(
                      np.float32)).to(dev),
                  cap=torch.from_numpy(cap.astype(np.float32)).to(dev),
                  ct=torch.from_numpy(ct).to(dev))
    return s, kw


def _eq(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,n_valid", [(1024, 1024), (3072, 3000),
                                       (66560, 65541)])
@pytest.mark.parametrize("w_m", [None, 0.0, 0.3])
@pytest.mark.parametrize("k", [1, 2, 8, 64, 65, 128])
def test_kernels_bitwise_equal_plain(dev, n, n_valid, w_m, k):
    s, kw = _streams(n, n + k, dev, w_m is not None)
    if w_m is not None:
        kw["en"] = torch.tensor([0.35, 0.65, 120.0, w_m], device=dev)
    lo, hi = mr.maiz_lohi_tiles(*s, n_valid, **kw)
    lo_p, hi_p = mr.maiz_lohi_plain(*s, n_valid, **kw)
    _eq(lo, lo_p)
    _eq(hi, hi_p)
    lohi = torch.stack([lo.amin(0), hi.amax(0)], -1)
    w = torch.tensor(W4, device=dev)
    got = mr.maiz_topk(*s, n_valid, lohi, w, k=k, **kw)
    want = mr.maiz_topk_plain(*s, n_valid, lohi, w, k=k, **kw)
    cpu = mr.maiz_topk_plain(*[x.cpu() for x in s], n_valid, lohi.cpu(),
                             w.cpu(), k=k,
                             **{a: b.cpu() for a, b in kw.items()})
    for x, y, z in zip(got, want, cpu):
        _eq(x, y)
        _eq(x, z)
    torch.cuda.synchronize()


def test_kernel_ties_and_short_tiles(dev):
    n = 4096
    s, _ = _streams(n, 1, dev, False, ties=True)
    w = torch.tensor(W4, device=dev)
    for n_valid in (n, 2050):           # last tile: 2 valid of k=16
        lohi = mr.maiz_lohi(*s, n_valid)
        got = mr.maiz_topk(*s, n_valid, lohi, w, k=16)
        want = mr.maiz_topk_plain(*s, n_valid, lohi, w, k=16)
        for x, y in zip(got, want):
            _eq(x, y)


def _level_streams(n, seed, dev, zero_frac):
    """Streams on a few levels, so that many nodes share their terms
    (exact score ties within and across tiles); ``zero_frac`` of the nodes
    sit at the minimum of terms 0, 1 and 3 and the maximum of term 2, the
    nodes whose every normalized term is 0."""
    g = np.random.default_rng(seed)
    zero = g.random(n) < zero_frac
    lv = lambda: g.integers(1, 4, n).astype(np.float32)  # noqa: E731
    ec, ci, fc = lv(), lv(), lv()
    eff, sw = g.integers(0, 3, n).astype(np.float32), lv()
    ec[zero], ci[zero], fc[zero], eff[zero], sw[zero] = 1, 1, 1, 2, 1
    s = [ec, np.ones(n, np.float32), ci, fc, eff, sw]
    return [torch.from_numpy(x).to(dev) for x in s]


# weights: the usual ones (ties at every level, +0.0 at the minimum), all
# negative (-0.0 where every normalized term is 0, the largest score), and
# -0.0 / +0.0 everywhere (every score a zero: the tile's first k ids)
_TIE_WEIGHTS = {"w4": W4, "neg": [-x for x in W4], "negzero": [-0.0] * 4,
                "zero": [0.0] * 4}


@pytest.mark.parametrize("weights", list(_TIE_WEIGHTS))
@pytest.mark.parametrize("k", [2, 16, 65, 128])
def test_topk_ties_zeros_and_short_tiles(dev, weights, k):
    """Exact ties within and across tiles, ±0.0 scores, and a last tile
    with fewer than k valid nodes (its ranks past the finite scores are
    +inf at tile-local index 0): K2 bitwise equal to its plain twin on the
    card and on the CPU; K4 over two lanes equal to its twin and, lane by
    lane, to K2."""
    n = 4096
    w = torch.tensor(_TIE_WEIGHTS[weights], device=dev)
    for zero_frac, n_valid in ((0.02, n), (0.9, n), (0.3, 3072 + 5)):
        s = _level_streams(n, k + int(100 * zero_frac), dev, zero_frac)
        lohi = mr.maiz_lohi(*s, n_valid)
        got = mr.maiz_topk(*s, n_valid, lohi, w, k=k)
        want = mr.maiz_topk_plain(*s, n_valid, lohi, w, k=k)
        cpu = mr.maiz_topk_plain(*[x.cpu() for x in s], n_valid,
                                 lohi.cpu(), w.cpu(), k=k)
        for x, y, z in zip(got, want, cpu):
            _eq(x, y)
            _eq(x, z)
        if n_valid < n:
            assert bool(torch.isinf(got[1][-1, 5:]).all())
            assert bool((got[2][-1, 5:] == 3 * 1024).all())
        lanes = [s, [x.flip(0).contiguous() for x in s]]
        sb = [torch.stack([a[i] for a in lanes]) for i in range(6)]
        lohi_b = mr.maiz_lohi_b(*sb, n_valid)
        got_b = mr.maiz_topk_b(*sb, n_valid, lohi_b, w, k=k)
        for x, y in zip(got_b, mr.maiz_topk_plain_b(*sb, n_valid, lohi_b, w,
                                                    k=k)):
            _eq(x, y)
        for l in range(2):
            for x, y in zip(got_b, mr.maiz_topk(*lanes[l], n_valid,
                                                lohi_b[l], w, k=k)):
                _eq(x[l], y)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [5000, 70000, 1_000_003])
@pytest.mark.parametrize("k", [65, 100, 128])
def test_merged_topk_tile_route_equals_full_vector(dev, n, k):
    """A shortlist above the reference's tile cap merges the kernel's tile
    candidates; it equals the full-vector merge (``lex_head`` of the
    scores) bit for bit, and the CPU path."""
    s, kw = _streams(n, n + k, dev, True)
    kw = {("chips_total" if a == "ct" else a): b for a, b in kw.items()}
    kw["en"] = torch.tensor([0.35, 0.65, 120.0, 0.3], device=dev)
    w = torch.tensor(W4, device=dev)
    mr.reset_launch_counts()
    scores, top_s, top_i = ops.maiz_ranking_topk(*s, w, k=k, **kw)
    assert mr.maiz_topk.launches == 1
    full_s, full_i = ops.lex_head(scores, k)
    _eq(top_s, full_s)
    _eq(top_i, full_i.to(torch.int32))
    cpu = ops.maiz_ranking_topk(*[x.cpu() for x in s], w.cpu(), k=k,
                                **{a: b.cpu() for a, b in kw.items()})
    for x, y in zip((scores, top_s, top_i), cpu):
        _eq(x, y)


def test_launch_counters_and_fused_ranking(dev):
    mr.reset_launch_counts()
    s, _ = _streams(5000, 3, dev, False)
    scores, best_s, best_n = ops.maiz_ranking_fused(
        *s, torch.tensor(W4, device=dev))
    assert mr.maiz_lohi.launches == 1 and mr.maiz_topk.launches == 1
    assert int(best_n) == int(torch.argmin(scores))


def test_placement_kernel_path_equals_cpu_path(dev):
    f_gpu = fleetlib.synthetic_fleet(8192, seed=1, device=dev)
    f_cpu = fleetlib.synthetic_fleet(8192, seed=1, device="cpu")
    demands = [64] * 64
    a = P.place_jobs_shortlist(f_gpu, demands, shortlist=16,
                               use_kernel=True)
    b = P.place_jobs_shortlist(f_cpu, demands, shortlist=16,
                               use_kernel=True)
    c = P.place_jobs_full_rerank(f_gpu, demands)
    _eq(a.node, b.node)
    _eq(a.capacity, b.capacity)
    assert a.n_sweeps == b.n_sweeps
    _eq(P.place_jobs_shortlist(f_gpu, demands, shortlist=16).node, c.node)


def _lane_streams(L, n, seed, dev, marginal):
    per = [_streams(n, seed + l, dev, marginal) for l in range(L)]
    s = [torch.stack([p[0][i] for p in per]) for i in range(6)]
    kw = {k: torch.stack([p[1][k] for p in per]) for k in per[0][1]}
    return s, kw


@pytest.mark.parametrize("n,n_valid", [(3072, 3000), (66560, 65541)])
@pytest.mark.parametrize("w_m", [None, 0.0, 0.3])
@pytest.mark.parametrize("k", [1, 2, 64, 65, 128])
def test_batched_kernels_bitwise_equal_plain_and_sequential(dev, n, n_valid,
                                                            w_m, k):
    L = 3
    s, kw = _lane_streams(L, n, n + k, dev, w_m is not None)
    if w_m is not None:
        kw["en"] = torch.tensor([[0.35, 0.65, 120.0, w_m],
                                 [0.25, 0.75, 0.0, w_m],
                                 [0.4, 0.6, 30.0, w_m]], device=dev)
    mr.reset_launch_counts()
    lo, hi = mr.maiz_lohi_tiles_b(*s, n_valid, **kw)
    lo_p, hi_p = mr.maiz_lohi_plain_b(*s, n_valid, **kw)
    _eq(lo, lo_p)
    _eq(hi, hi_p)
    lohi = torch.stack([lo.amin(1), hi.amax(1)], -1)
    w = torch.tensor(W4, device=dev)
    got = mr.maiz_topk_b(*s, n_valid, lohi, w, k=k, **kw)
    want = mr.maiz_topk_plain_b(*s, n_valid, lohi, w, k=k, **kw)
    for x, y in zip(got, want):
        _eq(x, y)
    assert mr.maiz_lohi_b.launches == 1 and mr.maiz_topk_b.launches == 1
    for l in range(L):
        lkw = {a: b[l].contiguous() for a, b in kw.items()}
        lane = [x[l].contiguous() for x in s]
        lo1, hi1 = mr.maiz_lohi_tiles(*lane, n_valid, **lkw)
        _eq(lo[l], lo1)
        _eq(hi[l], hi1)
        for x, y in zip(got, mr.maiz_topk(*lane, n_valid, lohi[l], w, k=k,
                                          **lkw)):
            _eq(x[l], y)
    torch.cuda.synchronize()


def test_ensemble_kernel_lanes_equal_cpu_and_host_loop(dev):
    """w2 = 0: the forecast (gels on the card, gelsd on the CPU) is not an
    input, so the card's and the CPU's trajectories must agree."""
    cfg = S.SimConfig(epochs=12, arrival_rate=6.0, mean_duration_h=6.0,
                      shortlist=16, history_h=48, horizon_h=8,
                      migration_budget=2, outage=(0, 4, 4), use_kernel=True,
                      weights=RankWeights(0.35, 0.0, 0.5, 0.15))
    out = {}
    for d in (dev, "cpu"):
        runs = []
        for seed in (0, 1):
            c = dataclasses.replace(cfg, seed=seed)
            f, t, r = S.synthetic_lifecycle_fleet(2048, c, chips_per_node=64,
                                                  device=d)
            runs.append((f, t, r, c, S.generate_jobs(c)))
        mr.reset_launch_counts()
        out[str(d)] = S.simulate_fleet_ensemble(runs)
        if d == dev:
            assert mr.maiz_topk_b.launches > 0
            host = [S.simulate_fleet(*spec[:4], jobs=spec[4])
                    for spec in runs]
    for a, b, h in zip(out[str(dev)], out["cpu"], host):
        assert np.array_equal(a.node_log, b.node_log)
        assert np.array_equal(a.start_epoch, b.start_epoch)
        assert a.rank_sweeps == b.rank_sweeps
        assert np.array_equal(a.node_log, h.node_log)
        assert a.rank_sweeps == h.rank_sweeps


def test_ensemble_kernel_lanes_equal_cpu_and_host_loop_with_forecast(dev):
    """The paper's default weights (w2 = 0.25): the forecast (a float64
    fit on both devices) feeds FCFP and the deferral signal, and the
    card's trajectories still equal the CPU's and the host loop's."""
    cfg = S.SimConfig(epochs=12, arrival_rate=6.0, mean_duration_h=6.0,
                      shortlist=16, history_h=48, horizon_h=8,
                      migration_budget=2, outage=(0, 4, 4), use_kernel=True,
                      deferrable_frac=0.3)
    assert cfg.weights.w2 == 0.25
    out = {}
    for d in (dev, "cpu"):
        runs = []
        for seed in (0, 1):
            c = dataclasses.replace(cfg, seed=seed)
            f, t, r = S.synthetic_lifecycle_fleet(2048, c, chips_per_node=64,
                                                  device=d)
            runs.append((f, t, r, c, S.generate_jobs(c)))
        mr.reset_launch_counts()
        out[str(d)] = S.simulate_fleet_ensemble(runs)
        if d == dev:
            assert mr.maiz_topk_b.launches > 0
            host = [S.simulate_fleet(*spec[:4], jobs=spec[4])
                    for spec in runs]
    for a, b, h in zip(out[str(dev)], out["cpu"], host):
        for other in (b, h):
            assert np.array_equal(a.node_log, other.node_log)
            assert np.array_equal(a.start_epoch, other.start_epoch)
            assert a.rank_sweeps == other.rank_sweeps
            assert a.jobs_deferred == other.jobs_deferred
        assert a.emissions_g == pytest.approx(b.emissions_g, rel=1e-4)


def test_forecast_card_equals_cpu(dev):
    """The float64 fit on the card and on the CPU, on 48- and 336-hour
    windows: within 1e-5 of each region's scale (the bar the CPU tests
    hold against the reference)."""
    from repro_torch.core import forecast
    for seed, hist, hor in ((11, 48, 12), (1, 336, 24)):
        cfg = S.SimConfig(epochs=24, seed=seed, history_h=hist,
                          horizon_h=hor)
        _, tr, _ = S.synthetic_lifecycle_fleet(8, cfg, device="cpu")
        tr = torch.from_numpy(tr.astype(np.float32))
        for t in range(0, cfg.epochs, 5):
            win = tr[:, t:t + hist]
            card, _ = forecast.forecast_regions(win.to(dev), hor, 0)
            cpu, _ = forecast.forecast_regions(win, hor, 0)
            gap = (card.cpu() - cpu).abs().amax(1)
            assert bool((gap <= 1e-5 * cpu.abs().amax(1)).all())


# ---------------------------------------------------------------------------
# the carbon policies, signal faults and tenants: card == CPU
# ---------------------------------------------------------------------------


def _chaos():
    from repro_torch.core.faults import FaultConfig
    return FaultConfig(ci_dropout=0.6, stale_cap_h=2, safe_stale_h=4,
                       telem_sigma=0.1, fc_outage=((5, 4),), fc_dropout=0.2,
                       mig_fail=0.4, flap_rate=0.03, quarantine_h=2)


def _same(a, b, rel):
    for f in ("node_log", "first_node", "start_epoch"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for f in ("rank_sweeps", "arrivals_placed", "jobs_completed",
              "jobs_dropped", "jobs_deferred", "migrations", "evictions",
              "migrations_failed", "jobs_active_end", "safe_epochs",
              "deadline_misses", "defer_delay_h"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.emissions_g == pytest.approx(b.emissions_g, rel=rel, abs=0)


def _both_devices(dev, cfg, n=96):
    """{device: (host loop, scan)} of one stream on the card and the CPU."""
    out = {}
    for d in (dev, "cpu"):
        f, t, r = S.synthetic_lifecycle_fleet(n, cfg, chips_per_node=64,
                                              device=d)
        jobs = S.generate_jobs(cfg)
        out[str(d)] = (S.simulate_fleet(f, t, r, cfg, jobs=jobs),
                       S.simulate_fleet_scan(f, t, r, cfg, jobs=jobs))
    return out[str(dev)], out["cpu"]


def test_chaos_probe_card_equals_cpu(dev):
    """The reference bench's chaos probe: every fault class, outages, a
    flash of failures; host loop and scan on the card == the CPU's."""
    cfg = S.SimConfig(epochs=36, seed=3, arrival_rate=6.0,
                      mean_duration_h=12.0, migration_budget=2,
                      deferrable_frac=0.3, shortlist=16, history_h=48,
                      horizon_h=8, outage=[(0, 6, 4), (1, 18, 4)],
                      faults=_chaos(), use_kernel=True)
    (hc, sc), (hp, sp) = _both_devices(dev, cfg)
    _same(hc, hp, 0.0)
    _same(sc, sp, 1e-6)
    _same(sc, hc, 1e-4)
    assert hc.migrations_failed > 0 and hc.evictions > 0


@pytest.mark.parametrize("policy", ["slo", "combined"])
def test_slo_stream_card_equals_cpu(dev, policy):
    from repro_torch.core import policy as P
    pcfg = P.slo_deferral(value_weight=0.7, deadline_hi=8) \
        if policy == "slo" else P.PolicyConfig(migration="lookahead",
                                               deferral="slo")
    cfg = S.SimConfig(epochs=36, seed=11, arrival_rate=8.0,
                      mean_duration_h=10.0, shortlist=32, history_h=48,
                      horizon_h=12, migration_budget=2, deferrable_frac=0.5,
                      outage=(0, 12, 6), flash_crowd=(20, 3, 2.5),
                      policy=pcfg, n_tenants=3, use_kernel=True)
    (hc, sc), (hp, sp) = _both_devices(dev, cfg)
    _same(hc, hp, 0.0)
    _same(sc, sp, 1e-6)
    _same(sc, hc, 1e-4)
    assert hc.jobs_deferred > 0
    assert np.array_equal(hc.tenant_emissions_g, hp.tenant_emissions_g)
    # the tenants' bins: float64 sums of the same f32 shares; the idle bin
    # carries the f32 rounding of each epoch's total (summed in the
    # device's order), so it is held to the emissions' card-vs-CPU bar
    np.testing.assert_allclose(sc.tenant_emissions_g[:-1],
                               sp.tenant_emissions_g[:-1], rtol=1e-9)
    assert abs(sc.tenant_emissions_g[-1] - sp.tenant_emissions_g[-1]) \
        <= 1e-6 * sp.emissions_g
    assert sc.tenant_emissions_g.sum() == pytest.approx(sc.emissions_g,
                                                        rel=1e-5)


def test_planner_lanes_kernel_equal_plain_and_cpu(dev):
    """Green-window planner lanes with per-epoch flap eligibility and a
    degraded CI trace: K4's lanes == the plain sweep's on the card, == the
    CPU's, == the host loop's."""
    from repro_torch.core import policy as P
    from repro_torch.core.faults import FaultConfig
    cfg = S.SimConfig(epochs=24, arrival_rate=8.0, mean_duration_h=10.0,
                      shortlist=16, history_h=48, horizon_h=12,
                      migration_budget=2, deferrable_frac=0.2,
                      policy=P.green_window(), use_kernel=True,
                      faults=FaultConfig(ci_dropout=0.5, stale_cap_h=3,
                                         flap_rate=0.02, quarantine_h=2))
    out = {}
    for d, kern in ((dev, True), (dev, False), ("cpu", True)):
        runs = []
        for seed in (11, 12):
            c = dataclasses.replace(cfg, seed=seed, use_kernel=kern)
            f, t, r = S.synthetic_lifecycle_fleet(2048, c, chips_per_node=64,
                                                  device=d)
            runs.append((f, t, r, c, S.generate_jobs(c)))
        mr.reset_launch_counts()
        out[(str(d), kern)] = S.simulate_fleet_ensemble(runs)
        if d == dev and kern:
            assert mr.maiz_topk_b.launches > 0
            host = [S.simulate_fleet(*sp[:4], jobs=sp[4]) for sp in runs]
    for a, b, c, h in zip(out[(str(dev), True)], out[(str(dev), False)],
                          out[("cpu", True)], host):
        _same(a, b, 1e-6)
        _same(a, c, 1e-6)
        _same(a, h, 1e-4)


def _serving_cfg(**kw):
    """The reference serving bench's probe (benchmarks/run.py:1117-1147)."""
    from repro_torch.core.traffic import TrafficConfig
    cfg = S.SimConfig(epochs=24, seed=3, arrival_rate=16.0,
                      mean_duration_h=10.0, shortlist=16, history_h=48,
                      horizon_h=8, chips_lo=8, chips_hi=32, use_kernel=True,
                      traffic=TrafficConfig(req_rate=20000.0, n_svc=4,
                                            flash_rate=0.05,
                                            mu_per_chip=0.1), **kw)
    return cfg


def _with_router(cfg, slo, g):
    return dataclasses.replace(cfg, policy=dataclasses.replace(
        cfg.policy, router_slo_s=slo, router_greenness=g))


def _same_requests(a, b, rel):
    for f in ("req_served", "req_offered", "p99_violations"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.req_gco2 == pytest.approx(b.req_gco2, rel=rel, abs=0)
    assert a.req_p99_s == pytest.approx(b.req_p99_s, rel=10 * rel, abs=0)


def test_route_epoch_batched_card_equals_cpu(dev):
    """The batched router on seeded (L, S) lanes: every service carrying
    weight (the first-service mask with several Trues), many equal carbon
    keys, empty slots with jid -1, infeasible and overloaded lanes: the
    card's int32 scatter-adds, cumsums and stable sorts give the CPU's
    split bit for bit; the f32 p99 metric within 1e-6."""
    from repro_torch.core import router as R
    rng = np.random.default_rng(17)
    L, S_, n_svc = 12, 700, 4
    svc = rng.integers(-1, n_svc, (L, S_)).astype(np.int32)
    jid = np.stack([rng.permutation(S_) for _ in range(L)]).astype(np.int32)
    empty = rng.random((L, S_)) < 0.3
    svc[empty] = -1
    jid[empty] = -1
    w = np.where(svc >= 0, rng.integers(1, 5, (L, S_)), 0).astype(np.int32)
    cap = rng.integers(0, 300, (L, S_)).astype(np.int32)
    cap[3] = 0                                      # a lane all infeasible
    carbon = (rng.integers(0, 6, (L, S_)) * np.float32(41.5)).astype(
        np.float32)
    req = rng.integers(0, 65535, L).astype(np.int32)
    req[5] = 65535
    g = np.array([0.0, 0.25, 0.5, 0.75, 1.0, 1.0, 0.0, 0.5, 0.3, 1.0, 0.9,
                  0.1], np.float32)
    args = dict(req_t=req, svc=svc, jid=jid, weight=w, cap=cap,
                carbon=carbon, greenness=g)
    out = {}
    for d in (dev, torch.device("cpu")):
        t = {k: torch.from_numpy(v).to(d) for k, v in args.items()}
        routed, offered = R.route_epoch_batched(n_svc=n_svc, **t)
        out[d.type] = (routed.cpu(), offered.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    # the first-service argmax: the first of several tied maxima
    mask = torch.tensor([[0, 1, 1, 1], [1, 1, 0, 1], [0, 0, 0, 1]],
                        dtype=torch.int32)
    assert torch.argmax(mask.to(dev), dim=1).tolist() == \
        torch.argmax(mask, dim=1).tolist() == [1, 0, 3]
    chips = torch.from_numpy(rng.integers(0, 33, (L, S_)))
    mu = torch.full((L, 1), 0.1)
    p_cpu = R.modeled_p99(torch, out["cpu"][0], chips, 32, mu)
    p_dev = R.modeled_p99(torch, out["cpu"][0].to(dev), chips.to(dev), 32,
                          mu.to(dev)).cpu()
    torch.testing.assert_close(p_dev, p_cpu, rtol=1e-6, atol=0)


def test_serving_probe_card_scan_equals_cpu_host_loop(dev):
    """The reference bench's probe (n = 48, 3 tenants, SLO 12 s, γ 0.75):
    the card's scan and host loop == the CPU's host loop on the request
    counters and placements, at the reference's recorded 773,913 served,
    4 violations and digest e6b7b02c6bd36633."""
    import hashlib
    cfg = _with_router(_serving_cfg(n_tenants=3), 12.0, 0.75)
    jobs = S.generate_jobs(cfg)
    res = {}
    for d in (dev, "cpu"):
        f, t, r = S.synthetic_lifecycle_fleet(48, cfg, chips_per_node=64,
                                              device=d)
        res[str(d)] = (S.simulate_fleet(f, t, r, cfg, jobs=jobs),
                       S.simulate_fleet_scan(f, t, r, cfg, jobs=jobs))
    (hc, sc), (hp, _) = res[str(dev)], res["cpu"]
    _same(hc, hp, 0.0)
    _same(sc, hp, 1e-4)
    _same_requests(hc, hp, 0.0)
    _same_requests(sc, hp, 1e-4)
    assert (hp.req_served, hp.p99_violations) == (773913, 4)
    digest = hashlib.sha256(np.concatenate(
        [sc.node_log, sc.first_node]).tobytes()).hexdigest()[:16]
    assert digest == "e6b7b02c6bd36633"
    for r in (hc, sc):
        assert r.tenant_request_g[-1] == 0.0
        assert r.tenant_request_g.sum() == pytest.approx(r.req_gco2,
                                                         rel=1e-5)


def test_serving_grid_ensemble_card_equals_cpu(dev):
    """A 3 x 3 (SLO x greenness) grid, one bucket of kernel lanes: the
    card's ensemble == the CPU's lane by lane, K4 launched."""
    cfg = _serving_cfg()
    runs = {}
    for d in (dev, "cpu"):
        f, t, r = S.synthetic_lifecycle_fleet(48, cfg, chips_per_node=64,
                                              device=d)
        runs[str(d)] = [(f, t, r, _with_router(cfg, slo, g))
                        for slo in (10.5, 12.0, 18.0)
                        for g in (0.0, 0.5, 1.0)]
    keys = {S._bucket_key(S._prepare_scan_run(*sp, pad_plan=True))
            for sp in runs[str(dev)]}
    assert len(keys) == 1
    mr.reset_launch_counts()
    card = S.simulate_fleet_ensemble(runs[str(dev)])
    assert mr.maiz_topk_b.launches > 0
    cpu = S.simulate_fleet_ensemble(runs["cpu"])
    for a, b in zip(card, cpu):
        _same(a, b, 1e-6)
        _same_requests(a, b, 1e-6)
        assert a.req_served > 0


def test_green_window_signals_card_equals_cpu(dev):
    from repro_torch.core import forecast
    rng = np.random.default_rng(3)
    fc = torch.from_numpy(rng.uniform(20, 600, (2, 24, 4, 24)).astype(
        np.float32))
    rpue = torch.tensor([1.1, 1.4, np.inf, 1.6], dtype=torch.float32)
    fc[:, :, 2] = 0.0                      # a node-less region at the floor
    for la_h, disc in ((12, 0.9), (48, 0.5), (1, 0.99)):
        card = forecast.green_window_signals(fc.to(dev), rpue.to(dev), la_h,
                                             disc)
        cpu = forecast.green_window_signals(fc, rpue, la_h, disc)
        for x, y in zip(card, cpu):
            _eq(x, y)


# ---------------------------------------------------------------------------
# the fused K1/K3 (one launch, the fold in the kernel) against the twins
# ---------------------------------------------------------------------------


def _fused_case(n, seed, dev, marginal, w_m, lanes):
    """Streams and kwargs for K1 (lanes None) or K3 over ``lanes``."""
    if lanes is None:
        s, kw = _streams(n, seed, dev, marginal)
        if marginal:
            kw["en"] = torch.tensor([0.35, 0.65, 120.0, w_m], device=dev)
        return s, kw
    s, kw = _lane_streams(lanes, n, seed, dev, marginal)
    if marginal:
        rows = [[0.35, 0.65, 120.0], [0.25, 0.75, 0.0], [0.4, 0.6, 30.0]]
        kw["en"] = torch.tensor([rows[l % 3] + [w_m] for l in range(lanes)],
                                device=dev)
    return s, kw


def _fused(s, n_valid, kw, lanes):
    if lanes is None:
        return (mr.maiz_lohi(*s, n_valid, **kw),
                mr.fold_lohi(*mr.maiz_lohi_plain(*s, n_valid, **kw)))
    return (mr.maiz_lohi_b(*s, n_valid, **kw),
            mr.fold_lohi(*mr.maiz_lohi_plain_b(*s, n_valid, **kw)))


@pytest.mark.parametrize("n,n_valid", [(1024, 1024), (1024, 1000),
                                       (2048, 2048), (2048, 1100),
                                       (1 << 20, 1 << 20),
                                       (1 << 20, 1_000_003)])
@pytest.mark.parametrize("w_m", [None, 0.3])
@pytest.mark.parametrize("lanes", [None, 1, 3, 8])
def test_fused_lohi_bitwise_equal_twin_fold(dev, n, n_valid, w_m, lanes):
    """K1 (lanes None) and K3 in one launch each: bitwise the twins'
    folded (R, 2) / (L, R, 2), on the card and on the CPU; each K3 lane
    equals K1 on that lane."""
    s, kw = _fused_case(n, n + (lanes or 0), dev, w_m is not None,
                        w_m or 0.0, lanes)
    mr.reset_launch_counts()
    got, want = _fused(s, n_valid, kw, lanes)
    assert (mr.maiz_lohi.launches, mr.maiz_lohi_b.launches) == (
        (1, 0) if lanes is None else (0, 1))
    _eq(got, want)
    cpu, _ = _fused([x.cpu() for x in s], n_valid,
                    {a: b.cpu() for a, b in kw.items()}, lanes)
    _eq(got, cpu)
    if lanes is not None:
        for l in range(lanes):
            _eq(got[l], mr.maiz_lohi(*[x[l] for x in s], n_valid,
                                     **{a: b[l] for a, b in kw.items()}))
    torch.cuda.synchronize()


@pytest.mark.parametrize("zero_frac,n_valid", [(0.02, 4096), (0.9, 4096),
                                               (0.3, 3077)])
@pytest.mark.parametrize("lanes", [None, 3])
def test_fused_lohi_ties_and_zeros(dev, zero_frac, n_valid, lanes):
    """Streams on a few levels (every min and max tied across many nodes
    and tiles, eff's zeros at its min): bitwise the twins' fold."""
    s = _level_streams(4096, int(100 * zero_frac), dev, zero_frac)
    if lanes is not None:
        s = [torch.stack([x.roll(997 * l) for l in range(lanes)]) for x in s]
    got, want = _fused(s, n_valid, {}, lanes)
    _eq(got, want)


@pytest.mark.parametrize("n_valid", [4096, 3000])
def test_fused_lohi_signed_zeros_in_different_tiles(dev, n_valid):
    """+0.0 in one tile and -0.0 in another for the same term (eff's and
    sched's min, the CFP terms' max): K1 and K3 order -0.0 below +0.0, as
    the twins' fold does, whatever order the blocks finish in."""
    n = 4096
    g = np.random.default_rng(5)
    s = [g.random(n).astype(np.float32) + 1 for _ in range(6)]
    s[0] = -s[0]
    s[0][5], s[0][1024 + 9] = 0.0, -0.0
    s[4][100], s[4][2048 + 7] = 0.0, -0.0
    s[5][10], s[5][3000] = 0.0, -0.0
    s = [torch.from_numpy(x).to(dev) for x in s]
    for _ in range(3):
        got, want = _fused(s, n_valid, {}, None)
        _eq(got, want)
        assert bool(torch.signbit(got[2, 0]))         # eff's -0.0
        assert not bool(torch.signbit(got[:2, 1]).any())   # +0.0 maxima
    lanes = [torch.stack([x, x.flip(0), x]) for x in s]
    got, want = _fused(lanes, n_valid, {}, 3)
    _eq(got, want)


def test_fused_lohi_misaligned_stream_raises(dev):
    """A stream that does not start on a 16-byte boundary is refused by
    K1, K3 and the per-tile launchers (no other route is taken)."""
    n = 2048
    s, _ = _streams(n, 4, dev, False)
    mis = torch.zeros(n + 4, device=dev)[1:n + 1]
    assert mis.is_contiguous() and mis.data_ptr() % 16
    mr.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        mr.maiz_lohi(mis, *s[1:], n)
    with pytest.raises(ValueError, match="16-byte"):
        mr.maiz_lohi_tiles(*s[:3], mis, *s[4:], n)
    wide = torch.zeros(2 * n + 4, device=dev)[1:2 * n + 1].view(2, n)
    lanes = [torch.stack([x, x]) for x in s]
    with pytest.raises(ValueError, match="16-byte"):
        mr.maiz_lohi_b(*lanes[:5], wide, n)
    assert all(f.launches == 0 for f in mr.WRAPPERS)


def test_fused_lohi_state_per_stream(dev):
    """Many launches, alternating between two streams, each with its own
    state (reset by every launch's last block): every result equals the
    twin's fold."""
    n = 1 << 16
    cases = [_fused_case(n, 30 + i, dev, i % 2 == 1, 0.3, 4 if i > 1 else
                         None) for i in range(4)]
    want = [_fused(s, n - 5, kw, 4 if i > 1 else None)[1]
            for i, (s, kw) in enumerate(cases)]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize()
    got = []
    for rep in range(8):
        with torch.cuda.stream(streams[rep % 2]):
            i = rep % 4
            got.append((i, _fused(cases[i][0], n - 5, cases[i][1],
                                  4 if i > 1 else None)[0]))
    torch.cuda.synchronize()
    for i, g in got:
        _eq(g, want[i])


# ---------------------------------------------------------------------------
# K5 flash attention / K6 selective scan against their plain versions
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import (attention_plain,  # noqa: E402
                                                 flash_attention)
from repro_torch.kernels.selective_scan import (selective_scan,  # noqa: E402
                                                selective_scan_plain)


@pytest.mark.parametrize("B,H,K,S,hd,window", [
    (2, 4, 4, 256, 64, 0), (1, 8, 2, 128, 128, 0), (2, 4, 1, 256, 64, 0),
    (2, 4, 4, 256, 64, 128), (1, 2, 2, 384, 128, 0), (1, 4, 2, 512, 32, 256),
    (1, 4, 2, 200, 64, 0), (2, 6, 3, 77, 120, 30), (4, 32, 8, 512, 64, 0),
    # the prefill shapes of moonshot-v1-16b-a3b, qwen2-vl-72b (GQA 8:1)
    # and zamba2-1.2b's tied block
    (4, 16, 16, 512, 128, 0), (4, 64, 8, 512, 128, 0),
    (4, 32, 32, 512, 64, 0),
    # nemotron-4-340b's head dim 192, 12:1 (96 heads over 8)
    (2, 24, 2, 512, 192, 0), (1, 12, 1, 333, 192, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, B, H, K, S, hd, window,
                                              dtype):
    g = torch.Generator(device=dev).manual_seed(S + hd)
    q = torch.randn(B, H, S, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, K, S, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, K, S, hd, generator=g, device=dev).to(dtype)
    n = flash_attention.launches
    got = flash_attention(q, k, v, window=window)
    assert flash_attention.launches == n + 1
    want = attention_plain(q, k, v, window=window)
    tol = 5e-6 if dtype == torch.float32 else 6e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,S,D,N", [(2, 32, 128, 16), (1, 64, 256, 16),
                                     (2, 48, 128, 8), (2, 37, 96, 16),
                                     (1, 45, 200, 8), (4, 512, 8192, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_matches_plain(dev, B, S, D, N, dtype):
    g = torch.Generator(device=dev).manual_seed(S + D)
    dt = (torch.rand(B, S, D, generator=g, device=dev) * 0.1 + 0.01)
    x = torch.randn(B, S, D, generator=g, device=dev)
    b = torch.randn(B, S, N, generator=g, device=dev)
    c = torch.randn(B, S, N, generator=g, device=dev)
    a = -torch.exp(torch.randn(D, N, generator=g, device=dev) * 0.3)
    dt, x = dt.to(dtype), x.to(dtype)
    n = selective_scan.launches
    y, h = selective_scan(dt, x, b, c, a)
    assert selective_scan.launches == n + 1
    y_p, h_p = selective_scan_plain(dt, x, b, c, a)
    tol = 2e-6 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y.float(), y_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, h_p, atol=tol, rtol=tol)


# the bf16 route's edge cases: one row, a long sequence, a GQA group of 8,
# head dims padded to 64, 128 and 192 (32, 120, 150), windows that end
# inside a kv tile, and q scaled by 8 so the running max moves tile to
# tile and the accumulator is rescaled in registers; each on contiguous
# (B, H, S, hd) tensors and on the model's transposed (B, S, H, hd)
# views.  hd % 8 == 0 takes the TMA-fed wgmma kernel on either layout
# (no copy), hd 150 the element-wise mma kernel
@pytest.mark.parametrize("B,H,K,S,hd,window", [
    (2, 4, 4, 1, 64, 0), (1, 8, 1, 2048, 64, 0), (2, 16, 2, 200, 64, 0),
    (1, 4, 2, 300, 32, 0), (1, 4, 2, 300, 120, 0), (1, 4, 2, 333, 64, 100),
    (2, 4, 1, 260, 128, 70), (1, 2, 2, 2048, 120, 500),
    (1, 12, 1, 300, 192, 0), (2, 4, 1, 260, 150, 70),
    (1, 12, 1, 2048, 192, 500)])
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_attention_bf16_edge_cases(dev, B, H, K, S, hd, window,
                                         q_scale, layout):
    g = torch.Generator(device=dev).manual_seed(S * hd + window)

    def draw(heads, scale=1.0):
        shape = (B, heads, S, hd) if layout == "bhsd" else (B, S, heads, hd)
        t = (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)
        return t if layout == "bhsd" else t.transpose(1, 2)

    q, k, v = draw(H, q_scale), draw(K), draw(K)
    route = "bf16-wgmma" if hd % 8 == 0 else "bf16-mma"
    n = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, window=window)
    assert flash_attention.route_launches == {**n, route: n[route] + 1}
    want = attention_plain(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=6e-3,
                               rtol=6e-3)


def test_flash_attention_routes_and_staging(dev):
    """A bf16 head dim whose rows are no 16-byte multiple (hd % 8), or a
    tensor that is not 16-byte aligned, takes the element-wise mma kernel;
    bf16 rows padded past hd (strides no 16-byte multiple) go to the
    wgmma kernel as contiguous copies; f32 takes the FMA kernel, with
    element-wise staging for hd % 4 or a misaligned tensor.  Each counts
    on its own route."""
    g = torch.Generator(device=dev).manual_seed(5)
    for dtype, hd, offset, route in (
            (torch.bfloat16, 60, 0, "bf16-mma"),
            (torch.bfloat16, 64, 1, "bf16-mma"),
            (torch.float32, 64, 0, "f32"),
            (torch.float32, 60, 0, "f32"),
            (torch.float32, 30, 0, "f32"),
            (torch.float32, 64, 1, "f32")):
        qkv = []
        for heads in (4, 2, 2):
            flat = torch.randn(2 * heads * 150 * hd + offset, generator=g,
                               device=dev).to(dtype)
            qkv.append(flat[offset:].view(2, heads, 150, hd))
        n = dict(flash_attention.route_launches)
        got = flash_attention(*qkv, window=40)
        assert flash_attention.route_launches == {**n, route: n[route] + 1}
        want = attention_plain(*qkv, window=40)
        tol = 6e-3 if dtype == torch.bfloat16 else 5e-6
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    # rows of 68 bf16 of which 64 are the head dim: 136-byte strides
    qkv = [torch.randn(2, heads, 150, 68, generator=g, device=dev).to(
        torch.bfloat16)[..., :64] for heads in (4, 2, 2)]
    n = dict(flash_attention.route_launches)
    got = flash_attention(*qkv, window=40)
    assert flash_attention.route_launches == {
        **n, "bf16-wgmma": n["bf16-wgmma"] + 1}
    torch.testing.assert_close(got.float(),
                               attention_plain(*qkv, window=40).float(),
                               atol=6e-3, rtol=6e-3)


# the prefill shapes of K5 bf16's table in PERF.md (granite-3-2b,
# moonshot-v1-16b-a3b, qwen2-vl-72b, zamba2-1.2b's tied block, nemotron-4-
# 340b's hd 192 at 12:1), as the model hands them over: views of (B, S,
# H, hd)
@pytest.mark.parametrize("B,H,K,S,hd", [
    (4, 32, 8, 512, 64), (4, 16, 16, 512, 128), (4, 64, 8, 512, 128),
    (4, 32, 32, 512, 64), (2, 24, 2, 512, 192)])
def test_flash_attention_prefill_shapes_take_the_wgmma_route(dev, B, H, K,
                                                             S, hd):
    """Each prefill shape takes the wgmma kernel on the model's views
    with no copy (the output has q's layout, so its transpose back is
    contiguous) and stays within K5's bf16 bar of the plain version."""
    g = torch.Generator(device=dev).manual_seed(B * H + hd)
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2) for n in (H, K, K))
    n = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v)
    assert flash_attention.route_launches == {
        **n, "bf16-wgmma": n["bf16-wgmma"] + 1}
    assert got.stride() == q.stride() and got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(),
                               attention_plain(q, k, v).float(),
                               atol=6e-3, rtol=6e-3)


@pytest.mark.parametrize("B,H,K,S,hd,window", [
    (4, 32, 8, 512, 64, 0), (2, 4, 1, 260, 128, 70), (1, 12, 2, 300, 192, 0)])
def test_flash_attention_graph_replay_equals_eager(dev, B, H, K, S, hd,
                                                   window):
    """A CUDA graph that captured the wgmma kernel (its tensor maps baked
    by value at the captured addresses) replays on whatever its inputs
    hold: with q, k and v rewritten in place, each replay equals an eager
    call on the new values bit for bit."""
    g = torch.Generator(device=dev).manual_seed(S + hd)
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device=dev).to(
        torch.bfloat16).transpose(1, 2) for n in (H, K, K))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        flash_attention(q, k, v, window=window)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention(q, k, v, window=window)
    for _ in range(2):
        for t in (q, k, v):
            t.copy_(torch.randn(t.shape, generator=g, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, flash_attention(q, k, v, window=window))


# the f32 route at the bf16 route's edge cases: q scaled by 8 makes the
# scores large (up to about 30), where an error in a score moves the
# softmax most
@pytest.mark.parametrize("B,H,K,S,hd,window", [
    (2, 4, 4, 1, 64, 0), (1, 8, 1, 2048, 64, 0), (2, 16, 2, 200, 64, 0),
    (1, 4, 2, 300, 32, 0), (1, 4, 2, 300, 120, 0), (1, 4, 2, 333, 64, 100),
    (2, 4, 1, 260, 128, 70), (1, 2, 2, 2048, 120, 500),
    (1, 12, 1, 300, 192, 0), (2, 4, 1, 260, 150, 70),
    (1, 12, 1, 2048, 192, 500)])
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_flash_attention_f32_edge_cases(dev, B, H, K, S, hd, window,
                                        q_scale):
    g = torch.Generator(device=dev).manual_seed(S * hd + window + 1)
    q = torch.randn(B, H, S, hd, generator=g, device=dev) * q_scale
    k = torch.randn(B, K, S, hd, generator=g, device=dev)
    v = torch.randn(B, K, S, hd, generator=g, device=dev)
    n = flash_attention.route_launches["f32"]
    got = flash_attention(q, k, v, window=window)
    assert flash_attention.route_launches["f32"] == n + 1
    want = attention_plain(q, k, v, window=window)
    torch.testing.assert_close(got, want, atol=5e-6, rtol=5e-6)


# the scan over 2048 steps with long memory (dt ~ 0.005: the state keeps
# hundreds of steps) and short memory (dt ~ 1), ragged D, N 8 and 16
@pytest.mark.parametrize("B,S,D,N,dt_lo,dt_hi", [
    (2, 2048, 256, 16, 0.004, 0.006), (1, 2048, 200, 8, 0.004, 0.006),
    (2, 2048, 96, 16, 0.5, 1.5), (1, 2048, 130, 8, 0.5, 1.5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_long_sequences(dev, B, S, D, N, dt_lo, dt_hi,
                                              dtype):
    g = torch.Generator(device=dev).manual_seed(D + N)
    dt = torch.rand(B, S, D, generator=g, device=dev) * (dt_hi - dt_lo) \
        + dt_lo
    x = torch.randn(B, S, D, generator=g, device=dev)
    b = torch.randn(B, S, N, generator=g, device=dev)
    c = torch.randn(B, S, N, generator=g, device=dev)
    a = -torch.exp(torch.randn(D, N, generator=g, device=dev) * 0.3)
    dt, x = dt.to(dtype), x.to(dtype)
    y, h = selective_scan(dt, x, b, c, a)
    y_p, h_p = selective_scan_plain(dt, x, b, c, a)
    tol = 2e-6 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y.float(), y_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, h_p, atol=tol, rtol=tol)


def test_selective_scan_elementwise_staging(dev):
    """dt/x that are not 16-byte aligned take the element-wise staging of
    the same kernel and agree with the plain version."""
    g = torch.Generator(device=dev).manual_seed(9)
    B, S, D, N = 2, 70, 128, 16
    flat = torch.rand(2 * B * S * D + 1, generator=g, device=dev)
    dt = flat[1:B * S * D + 1].view(B, S, D) * 0.1 + 0.01
    x = torch.randn(B * S * D + 1, generator=g, device=dev)[1:].view(B, S, D)
    b = torch.randn(B, S, N, generator=g, device=dev)
    c = torch.randn(B, S, N, generator=g, device=dev)
    a = -torch.exp(torch.randn(D, N, generator=g, device=dev) * 0.3)
    assert x.data_ptr() % 16
    y, h = selective_scan(dt.contiguous(), x, b, c, a)
    y_p, h_p = selective_scan_plain(dt, x, b, c, a)
    torch.testing.assert_close(y, y_p, atol=2e-6, rtol=2e-6)
    torch.testing.assert_close(h, h_p, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("B,S,D,N", [(2, 37, 96, 16), (1, 45, 200, 8),
                                     (4, 512, 8192, 16)])
def test_selective_scan_dn_form_is_bitwise(dev, B, S, D, N):
    """Mamba-1's (D, N) form in f32: y and h_S equal the plain version's
    bit for bit (the per-channel form left it as it was)."""
    g = torch.Generator(device=dev).manual_seed(B * S + N)
    dt = torch.rand(B, S, D, generator=g, device=dev) * 0.1 + 0.01
    x = torch.randn(B, S, D, generator=g, device=dev)
    b = torch.randn(B, S, N, generator=g, device=dev)
    c = torch.randn(B, S, N, generator=g, device=dev)
    a = -torch.exp(torch.randn(D, N, generator=g, device=dev) * 0.3)
    n = selective_scan.route_launches["dn"]
    y, h = selective_scan(dt, x, b, c, a)
    assert selective_scan.route_launches["dn"] == n + 1
    y_p, h_p = selective_scan_plain(dt, x, b, c, a)
    assert torch.equal(y, y_p) and torch.equal(h, h_p)


# K6's per-channel case of the per-head form (Mamba-2 with P = 1: a (D,)
# decay): zamba2-1.2b's prefill (B 4, S 512, D 4096, N 64) with one head a
# channel, ragged D and S, N 16 (the reduced zamba2), and 2048 steps with
# long and short memory
@pytest.mark.parametrize("B,S,D,N,dt_lo,dt_hi", [
    (4, 512, 4096, 64, 0.001, 0.1), (2, 37, 200, 64, 0.01, 0.11),
    (1, 45, 96, 16, 0.01, 0.11), (1, 2048, 130, 64, 0.004, 0.006),
    (2, 2048, 64, 64, 0.5, 1.5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_per_channel_matches_plain(dev, B, S, D, N, dt_lo,
                                                  dt_hi, dtype):
    g = torch.Generator(device=dev).manual_seed(S + D + N)
    dt = torch.rand(B, S, D, generator=g, device=dev) * (dt_hi - dt_lo) \
        + dt_lo
    x = torch.randn(B, S, D, generator=g, device=dev)
    b = torch.randn(B, S, N, generator=g, device=dev)
    c = torch.randn(B, S, N, generator=g, device=dev)
    a = -torch.exp(torch.randn(D, generator=g, device=dev) * 0.3)
    dt, x = dt.to(dtype), x.to(dtype)
    n = selective_scan.route_launches["per_channel"]
    y, h = selective_scan(dt, x, b, c, a)
    assert selective_scan.route_launches["per_channel"] == n + 1
    y_p, h_p = selective_scan_plain(dt, x, b, c, a)
    tol = 2e-6 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y.float(), y_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, h_p, atol=tol, rtol=tol)
    assert torch.equal(y, y_p) and torch.equal(h, h_p)


def _head_inputs(B, S, H, P, N, dt_lo, dt_hi, dtype, dev, offset=0):
    """Per-head inputs (dt (B, S, H), x (B, S, H·P), b, c, a (H,)); x
    starts ``offset`` elements into its buffer (1: not 16-byte aligned)."""
    g = torch.Generator(device=dev).manual_seed(S + H * P + N)
    dt = torch.rand(B, S, H, generator=g, device=dev) * (dt_hi - dt_lo) \
        + dt_lo
    x = torch.randn(B * S * H * P + offset, generator=g, device=dev)
    x = x.to(dtype)[offset:].view(B, S, H * P)
    b = torch.randn(B, S, N, generator=g, device=dev)
    c = torch.randn(B, S, N, generator=g, device=dev)
    a = -torch.exp(torch.randn(H, generator=g, device=dev) * 0.3)
    return dt.to(dtype), x, b, c, a


# K6's per-head form (Mamba-2: dt (B, S, H), a (H,)): zamba2-1.2b's prefill
# (H 64, P 64, N 64), the reduced zamba2 (P 32, N 16), a D that ends in the
# middle of a tile with a ragged S (P 24 and 3), tiles holding several heads
# and parts of heads (P 48, which does not divide the tile's 64 channels),
# and 2048 steps with long and short memory
@pytest.mark.parametrize("B,S,H,P,N,dt_lo,dt_hi", [
    (4, 512, 64, 64, 64, 0.001, 0.1), (2, 37, 8, 32, 16, 0.01, 0.11),
    (2, 37, 5, 24, 64, 0.01, 0.11), (1, 77, 50, 3, 16, 0.01, 0.11),
    (2, 100, 7, 48, 64, 0.01, 0.11), (1, 2048, 4, 64, 64, 0.004, 0.006),
    (2, 2048, 3, 48, 64, 0.5, 1.5), (1, 2048, 6, 32, 16, 0.5, 1.5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_per_head_is_bitwise(dev, B, S, H, P, N, dt_lo,
                                            dt_hi, dtype):
    dt, x, b, c, a = _head_inputs(B, S, H, P, N, dt_lo, dt_hi, dtype, dev)
    n = dict(selective_scan.route_launches)
    y, h = selective_scan(dt, x, b, c, a)
    assert selective_scan.route_launches == {**n, "per_channel":
                                             n["per_channel"] + 1}
    y_p, h_p = selective_scan_plain(dt, x, b, c, a)
    tol = 2e-6 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y.float(), y_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, h_p, atol=tol, rtol=tol)
    assert torch.equal(y, y_p) and torch.equal(h, h_p)
    # the per-channel case on dt and a repeated over each head's channels
    y_c, h_c = selective_scan(dt.repeat_interleave(P, -1), x, b, c,
                              a.repeat_interleave(P))
    assert torch.equal(y, y_c) and torch.equal(h, h_c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_per_head_elementwise_staging(dev, dtype):
    """x not 16-byte aligned takes the element-wise staging of the same
    kernel: bitwise the plain version."""
    dt, x, b, c, a = _head_inputs(2, 70, 6, 32, 64, 0.01, 0.11, dtype, dev,
                                  offset=1)
    assert x.data_ptr() % 16
    y, h = selective_scan(dt, x, b, c, a)
    y_p, h_p = selective_scan_plain(dt, x, b, c, a)
    assert torch.equal(y, y_p) and torch.equal(h, h_p)


def test_moe_combine_is_deterministic_on_the_card(dev):
    """One moonshot-v1-16b-a3b MoE layer at full width (64 experts, top
    6) on a 4 x 512 prefill in bf16: two runs give the same bits (the
    combine adds each token's rows in a fixed order, no atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import init_tree
    from repro_torch.models import moe
    cfg = get_config("moonshot-v1-16b-a3b")
    p = init_tree(moe.moe_template(cfg), 0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn(4, 512, cfg.d_model, generator=g, device=dev)
         * 0.3).to(torch.bfloat16)
    a, aux_a = moe.moe_apply(cfg, p, x)
    b, aux_b = moe.moe_apply(cfg, p, x)
    assert torch.isfinite(a.float()).all()
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# ---------------------------------------------------------------------------
# the training path (chip_smoke.py phase 14 (c) and (d), smaller)
# ---------------------------------------------------------------------------


# the training families of chip_smoke.py phase 14 (c) and (f): an id is an
# arch, with ":ssd" for zamba2's SSD route; the MoE families at capacity
# factor 16 (no drops), as the CPU suite holds them against the reference
TRAIN_FAMILIES = ["granite-3-2b", "falcon-mamba-7b", "h2o-danube-3-4b",
                  "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b",
                  "zamba2-1.2b", "zamba2-1.2b:ssd", "qwen2-vl-72b"]


def _train_case(name, dtype):
    """The reduced family of ``name``: (model, CPU parameters in ``dtype``
    with a random head, a batch maker ``(state, device) -> (state,
    batch)``: the pipeline's tokens, or the stub frontend's patch
    embeddings and M-RoPE ids with seeded labels)."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, PipelineState,
                                           device_batch)
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.models import frontend
    from repro_torch.models.model import ModelFlags, build_model
    arch, _, algo = name.partition(":")
    cfg = get_config(arch).reduced()
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    model = build_model(cfg, ModelFlags(attn_chunk=16, ssm_chunk=8,
                                        ssm_algo=algo or "scan"))
    gen = torch.Generator().manual_seed(1)
    params = model.init(generator=gen, device="cpu")
    if dtype == torch.float32:
        params = tree_map(lambda t: t.float(), params)
    params["lm_head"] = (torch.randn(cfg.d_model, cfg.vocab, generator=gen)
                         / math.sqrt(cfg.d_model)).to(dtype)
    dcfg = DataConfig(cfg, 2, 72, seed=1)

    def next_batch(ps, d):
        if cfg.input_mode != "embeddings":
            return device_batch(dcfg, ps, d)
        rng = np.random.default_rng(ps.step)
        return PipelineState(ps.seed, ps.step + 1), {
            "embeds": frontend.fake_patch_embeddings(
                cfg, 2, 72, seed=ps.step, device=d).to(dtype),
            "positions": frontend.mrope_position_ids(2, 72, grid=4,
                                                     device=d),
            "labels": torch.from_numpy(rng.integers(
                0, cfg.vocab, (2, 72)).astype(np.int32)).to(d)}
    return model, params, next_batch


@pytest.mark.parametrize("name", TRAIN_FAMILIES)
def test_train_steps_card_equal_cpu(dev, name):
    """f32 parameters with a random head, 3 AdamW steps from one state:
    losses rel 1e-4 card vs CPU at every step, step-0 gradients within
    1e-4 x max|g| per leaf (TF32 matmuls off, PyTorch's default); a leaf
    the loss does not read (qwen2-vl's token table) is zero on both."""
    from repro_torch.data.pipeline import PipelineState
    from repro_torch.distributed.sharding import tree_leaves, tree_map
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainState, make_grad_fn,
                                              make_train_step)
    assert not torch.backends.cuda.matmul.allow_tf32
    model, params, next_batch = _train_case(name, torch.float32)
    step_fn = make_train_step(model, AdamWConfig(lr_peak=3e-3,
                                                 warmup_steps=1,
                                                 total_steps=3))
    out = []
    for d in ("cpu", dev):
        # a copy per device: the train step updates its state in place
        p = tree_map(lambda t: t.to(d, copy=True), params)
        _, b0 = next_batch(PipelineState(1, 0), d)
        grads, _ = make_grad_fn(model)(p, b0)
        state, ps, losses = TrainState.create(p), PipelineState(1, 0), []
        for _ in range(3):
            ps, b = next_batch(ps, d)
            state, met = step_fn(state, b)
            losses.append(float(met["loss"]))
        out.append((losses, [g.cpu() for g in tree_leaves(grads)]))
    (lc, gc), (lg, gg) = out
    assert lg == pytest.approx(lc, rel=1e-4)
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("name", TRAIN_FAMILIES)
def test_train_grads_bitwise_on_two_card_runs(dev, name):
    """bf16 parameters (the model's own dtypes) with a random head: two
    card runs of ``make_grad_fn`` from one state give the same loss and
    gradients bit for bit, and so does a third under
    ``torch.use_deterministic_algorithms`` (which raises on an op with no
    deterministic form: the MoE's gathers and ``index_put_``s, the
    embedding's backward)."""
    from repro_torch.data.pipeline import PipelineState
    from repro_torch.distributed.sharding import tree_leaves, tree_map
    from repro_torch.train.train_step import make_grad_fn
    model, params, next_batch = _train_case(name, torch.bfloat16)
    p = tree_map(lambda t: t.to(dev), params)
    _, b = next_batch(PipelineState(1, 0), dev)
    grad_fn = make_grad_fn(model)
    runs = [grad_fn(p, b), grad_fn(p, b)]
    torch.use_deterministic_algorithms(True)
    try:
        runs.append(grad_fn(p, b))
    finally:
        torch.use_deterministic_algorithms(False)
    g0, m0 = runs[0]
    for g, m in runs[1:]:
        assert torch.equal(m["loss"], m0["loss"])
        for x, y in zip(tree_leaves(g0), tree_leaves(g)):
            assert torch.equal(x, y)


def test_train_loop_fault_restart_on_the_card(dev, tmp_path):
    """8 steps, a checkpoint every 2, a node failure at step 5: one
    restart, and the final loss rel 1e-4 of the clean run."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.fault_tolerance import FailureInjector
    common = dict(steps=8, batch=2, seq=32, reduced=True, ckpt_every=2,
                  device=dev, log=lambda m: None)
    clean = train_loop("granite-3-2b", ckpt_dir=str(tmp_path / "c"),
                       **common)
    faulty = train_loop("granite-3-2b", ckpt_dir=str(tmp_path / "f"),
                        injector=FailureInjector(
                            schedule={5: "node_failure"}), **common)
    assert faulty.restarts == 1 and faulty.steps_done == 8
    assert faulty.final_state.params["embed"].device.type == "cuda"
    assert faulty.losses[-1] == pytest.approx(clean.losses[-1], rel=1e-4)


# ---------------------------------------------------------------------------
# the kernels' custom ops and the step-cost counter on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_equal_the_bare_launches_bitwise(dev, dtype):
    """``flash_attention`` / ``selective_scan`` go through their custom ops;
    the outputs are the bare launches' bit for bit, one launch each."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import selective_scan as ss
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(2, 8, 96, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(2, 2, 96, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(2, 2, 96, 64, generator=g, device=dev).to(dtype)
    n = fa.flash_attention.launches
    assert torch.equal(fa.flash_attention(q, k, v, window=40),
                       fa.launch(q, k, v, 40))
    assert fa.flash_attention.launches == n + 2
    dt = (torch.rand(2, 50, 96, generator=g, device=dev) * 0.1).to(dtype)
    x = torch.randn(2, 50, 96, generator=g, device=dev).to(dtype)
    b, c = (torch.randn(2, 50, 16, generator=g, device=dev)
            for _ in range(2))
    a = -torch.rand(96, 16, generator=g, device=dev)
    n = ss.selective_scan.launches
    for got, want in zip(ss.selective_scan(dt, x, b, c, a),
                         ss.launch(dt, x, b, c, a)):
        assert torch.equal(got, want)
    assert ss.selective_scan.launches == n + 2
    # the per-head form: dt (B, S, H), a (H,), 3 heads of 32 channels
    dt, a = dt[..., :3].contiguous(), -torch.rand(3, generator=g, device=dev)
    b, c = (torch.randn(2, 50, 64, generator=g, device=dev)
            for _ in range(2))
    for got, want in zip(ss.selective_scan(dt, x, b, c, a),
                         ss.launch(dt, x, b, c, a)):
        assert torch.equal(got, want)
    assert ss.selective_scan.launches == n + 4


@pytest.mark.parametrize("arch", ["granite-3-2b", "falcon-mamba-7b",
                                  "moonshot-v1-16b-a3b", "zamba2-1.2b"])
def test_step_counts_on_the_card_equal_meta(dev, arch):
    """A reduced prefill and decode step counted on the card (through K5
    / K6's custom ops) == ``dryrun.count_cell`` on meta at the same
    shape: FLOPs and bytes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.step_cost import count_step
    from repro_torch.models.model import build_model
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device=dev)
    B, P, cache = 2, 24, 40
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        2, cfg.vocab, (B, P)), dtype=torch.int32, device=dev)}
    (lk, caches), pre = count_step(
        lambda: model.prefill(params, batch, cache), params, batch)
    step = {"token": lk.argmax(-1).to(torch.int32),
            "positions": torch.full((B,), P, dtype=torch.int32, device=dev)}
    _, dec = count_step(lambda: model.decode_step(params, caches, step),
                        params, caches, step)
    _, _, mp = dryrun.count_cell(cfg, ShapeSpec("p", "prefill", P, B), model,
                                 cache_len=cache)
    _, _, md = dryrun.count_cell(cfg, ShapeSpec("d", "decode", cache, B),
                                 model)
    assert (pre.flops, pre.bytes) == (mp.cost.flops, mp.cost.bytes)
    assert (dec.flops, dec.bytes) == (md.cost.flops, md.cost.bytes)
    assert {"flash_attention", "selective_scan"} & set(mp.by_op)


GRAPH_FAMILIES = ["granite-3-2b", "falcon-mamba-7b", "moonshot-v1-16b-a3b",
                  "zamba2-1.2b", "qwen2-vl-72b"]


def _graph_case(arch, dtype, dev):
    """A reduced model with seeded parameters in ``dtype`` (f32: every
    leaf; bf16: as ``init`` draws them) and a random head, a prompt batch
    and the inputs of decode step t given the last logits."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.models import frontend
    from repro_torch.models.model import build_model
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    params["lm_head"] = (torch.randn(cfg.d_model, cfg.vocab, generator=g,
                                     device=dev) / math.sqrt(cfg.d_model)
                         ).to(params["lm_head"].dtype)
    if dtype == torch.float32:
        params = tree_map(lambda t: t.float(), params)
    B, P, n_dec = 2, 24, 8
    if cfg.input_mode == "embeddings":
        emb = frontend.fake_patch_embeddings(cfg, B, P + n_dec, device=dev)
        emb = emb.to(dtype)
        ids = frontend.mrope_position_ids(B, P + n_dec, grid=4, device=dev)
        batch = {"embeds": emb[:, :P], "positions": ids[:, :P]}

        def step(t, logits):
            return {"embed": emb[:, P + t],
                    "positions": torch.full((B,), P + t, dtype=torch.long,
                                            device=dev),
                    "rope_positions": ids[:, P + t]}
    else:
        batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
            2, cfg.vocab, (B, P)), device=dev)}

        def step(t, logits):
            return {"token": logits.argmax(-1),
                    "positions": torch.full((B,), P + t, dtype=torch.long,
                                            device=dev)}
    return cfg, model, params, batch, step, B, P + n_dec + 4, n_dec


def _routes():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import selective_scan as ss
    return {**{("fa", r): n for r, n in fa.flash_attention.route_launches
               .items()},
            **{("ss", r): n for r, n in ss.selective_scan.route_launches
               .items()}}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _replayed(monkeypatch):
    """The CUDA graphs replayed from now on, one entry a replay."""
    seen = []
    replay = torch.cuda.CUDAGraph.replay

    def counted(graph):
        seen.append(graph)
        return replay(graph)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", counted)
    return seen


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", GRAPH_FAMILIES)
def test_captured_steps_equal_eager_bitwise(dev, arch, dtype, monkeypatch):
    """The engine's captured prefill (logits and caches) and 8 captured
    decode steps (logits, and the caches after them) are the eager
    steps' bit for bit, from the same caches; the decode graph advances
    the prefill graph's caches in place, so the Mamba states would show a
    warm-up that advanced them."""
    from repro_torch.distributed.sharding import tree_leaves
    from repro_torch.serve.engine import ServeEngine
    cfg, model, params, batch, step, B, cache, n_dec = _graph_case(
        arch, dtype, dev)
    eng = ServeEngine(model, params, max_seq=cache, batch_slots=B,
                      device=dev)
    replayed = _replayed(monkeypatch)
    le, ce = model.prefill(params, batch, cache)
    lg, cg = eng.prefill(batch)
    torch.cuda.synchronize()
    assert torch.equal(le, lg)
    leaves = tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(leaves(ce), leaves(cg)))
    for t in range(n_dec):
        s = step(t, le)
        le, ce = model.decode_step(params, ce, s)
        lg, cg = eng.decode(cg, s)
        assert torch.equal(le, lg), (arch, t)
    assert all(torch.equal(a, b) for a, b in zip(leaves(ce), leaves(cg)))
    assert eng._prefill.captures == eng._decode.captures == 1
    (entry,) = eng._decode.entries.values()
    assert replayed.count(entry.graph) == n_dec


@pytest.mark.parametrize("arch", GRAPH_FAMILIES)
def test_graph_launch_counts_are_captured_launches_times_replays(
        dev, arch, monkeypatch):
    """K5 / K6's counters after captured prefills: the warm-up runs' own
    launches, none for the capture, and the captured launches on each
    replay, route by route, each the eager prefill's."""
    from repro_torch._graphs import WARMUP
    from repro_torch.serve.engine import ServeEngine
    cfg, model, params, batch, _, B, cache, _ = _graph_case(
        arch, torch.bfloat16, dev)
    c0 = _routes()
    model.prefill(params, batch, cache)
    torch.cuda.synchronize()
    per = _delta(_routes(), c0)
    assert per and all(n > 0 for n in per.values())
    eng = ServeEngine(model, params, max_seq=cache, batch_slots=B,
                      device=dev)
    replayed = _replayed(monkeypatch)
    c1 = _routes()
    eng.prefill(batch)
    assert _delta(_routes(), c1) == {k: n * (WARMUP + 1)
                                     for k, n in per.items()}
    (entry,) = eng._prefill.entries.values()
    assert sorted(entry.launches.values()) == sorted(per.values())
    c2 = _routes()
    for _ in range(3):
        eng.prefill(batch)
    assert _delta(_routes(), c2) == {k: 3 * n for k, n in per.items()}
    assert replayed.count(entry.graph) == 4 and eng._prefill.captures == 1
    if cfg.input_mode == "tokens":
        # a generate at a new prompt length: one prefill and one decode
        # signature more, the timings refreshed
        eng.generate(np.full((B, 5), 3), 2)
        t = eng.timings
        assert t["warmup_prefills"] == 2 * WARMUP and t["captures"] == 3
        assert t["pool_bytes"] > 0 and t["capture_s"] > 0


def _below(ev, name):
    """The events named ``name`` below ``ev`` in the profiler's tree."""
    out = []
    for c in ev.cpu_children:
        out += ([c] if c.name == name else []) + _below(c, name)
    return out


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-1.2b"])
def test_serve_spans_on_the_card(dev, arch):
    """Under ``torch.profiler``: a fresh engine's first ``generate``
    records two ``graph.capture`` spans (prefill and decode), a second at
    the same length none and leaves ``warmup_s`` as it was; each captured
    decode step's ``graph.step`` holds a ``cudaGraphLaunch``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import _trace
    from repro_torch.serve.engine import ServeEngine
    _, model, params, batch, _, B, cache, _ = _graph_case(
        arch, torch.bfloat16, dev)
    eng = ServeEngine(model, params, max_seq=cache, batch_slots=B,
                      device=dev)
    prompts = batch["tokens"].cpu().numpy()
    new = 4
    cuda = torch.autograd.DeviceType.CUDA
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        first = eng.generate(prompts, new)
    names = [e.name for e in prof.events() if e.device_type != cuda]
    assert names.count(_trace.GRAPH_CAPTURE) == 2
    warm = eng.timings["warmup_s"]
    assert 0 < warm < eng.timings["capture_s"]
    with profile(activities=activities) as prof:
        second = eng.generate(prompts, new)
    assert [r.tokens for r in second] == [r.tokens for r in first]
    host = [e for e in prof.events() if e.device_type != cuda]
    assert _trace.GRAPH_CAPTURE not in {e.name for e in host}
    assert eng.timings["warmup_s"] == warm
    decodes = [e for e in host if e.name == _trace.DECODE]
    assert len(decodes) == new - 1
    for d in decodes:
        (step,) = _below(d, _trace.GRAPH_STEP)
        assert _below(step, "cudaGraphLaunch"), [c.name for c in
                                                 step.cpu_children]


@pytest.mark.parametrize("B,K,G", [(32, 8, 4), (24, 32, 1)])
def test_decode_attention_reads_the_bf16_cache_in_place(dev, B, K, G):
    """Single-device decode attention at granite-3-2b's served shape (B
    32, K 8, G 4) and zamba2-1.2b's tied block's (B 24, K 32, G 1), hd 64,
    a 3,021-slot bf16 cache, eager: the scores (``bmm``'s ``out_dtype``
    form on a view of the cache) within the f32 summation bound of the
    float64 product of the same values, as the replaced f32 einsum's are;
    the outputs within one bf16 ulp of the replaced formula's largest
    magnitude (``tests/test_torch_decode_attention.py`` states both bars);
    and one call allocates less than one layer's bf16 K cache, where the
    replaced formula's f32 copy of it alone took twice that."""
    import math

    from repro_torch.models import attention as A
    hd, cl = 64, 3021
    g = torch.Generator(device=dev).manual_seed(B * K)
    q = torch.randn(B, K, G, hd, generator=g, device=dev).bfloat16()
    ck = torch.randn(B, cl, K, hd, generator=g, device=dev).bfloat16()
    cv = torch.randn(B, cl, K, hd, generator=g, device=dev).bfloat16()
    pos = torch.randint(0, cl, (B,), generator=g, device=dev)
    pos[0], pos[1], pos[-1] = 0, 5, cl - 1
    scores = A._decode_scores(q, ck).view(B, cl, K, G)
    exact = torch.einsum("bkgh,btkh->btkg", q.double(), ck.double())
    bound = (hd + 1) * 2.0 ** -24 * torch.einsum(
        "bkgh,btkh->btkg", q.double().abs(), ck.double().abs())
    assert ((scores.double() - exact).abs() <= bound).all()
    ref = torch.einsum("bkgh,btkh->btkg", q.float(), ck.float())
    assert ((ref.double() - exact).abs() <= bound).all()
    del exact, bound, ref

    scale = hd ** -0.5
    valid = A._live_slots(torch.arange(cl, device=dev)[None, :], pos, pos,
                          cl, False)
    w = torch.softmax((torch.einsum("bkgh,btkh->bkgt", q.float(), ck.float())
                       * scale).masked_fill(~valid[:, None, None],
                                            A.NEG_INF), dim=-1)
    want = torch.einsum("bkgt,btkh->bkgh", w.to(cv.dtype), cv).float()
    del w
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = A._decode_attend(q, ck, cv, pos, pos, False)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated(dev) - m0
    assert grew < ck.numel() * ck.element_size(), grew
    top = want.abs().max().item()
    bar = 2.0 ** (math.floor(math.log2(top)) - 8)
    gap = (got.float() - want).abs().max().item()
    assert got.dtype == torch.bfloat16 and gap <= bar, (gap, bar)
