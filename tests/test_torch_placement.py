"""Port placement engines vs the JAX reference engines: node and capacity
exact, sweep counts equal — the cases of ``tests/test_placement.py``
(ragged N, ties, exhaustion, health mask, lifecycle releases), plus the
rank-kernel sweep path and the scheduler wrappers."""
import numpy as np
import pytest
import torch

from test_torch_reference import bits, jnp, load_reference, port_fleet

from repro_torch.core import placement as P
from repro_torch.core import scheduler


def _uniform_fleet(n, chips=8, cap=8):
    """Every node identical -> every score ties exactly (reference fleet)."""
    ref = load_reference()
    ones = jnp().ones((n,), jnp().float32)
    return ref.fleet.Fleet(
        ci_now=300.0 * ones, ci_forecast=310.0 * ones, pue=1.2 * ones,
        power_kw=10.0 * ones,
        capacity=jnp().full((n,), cap, jnp().int32),
        healthy=jnp().ones((n,), bool),
        straggler_score=jnp().zeros((n,), jnp().float32),
        flops_per_j=1e9 * ones,
        chips_total=jnp().full((n,), chips, jnp().int32))


def _same(a, b):
    np.testing.assert_array_equal(a.node.numpy(), np.asarray(b.node))
    np.testing.assert_array_equal(a.capacity.numpy(), np.asarray(b.capacity))
    assert a.n_sweeps == int(b.n_sweeps)
    np.testing.assert_array_equal(bits(a.scores), bits(b.scores))


def _check(fr, demands, nodes=None, shortlist=8, **kw):
    """Both engines of the port == the reference's, event for event; the
    port's shortlist engine == its full oracle.  Returns the port's
    (shortlist, full) results."""
    ref = load_reference()
    fp = port_fleet(fr)
    nodes = [-1] * len(demands) if nodes is None else nodes
    dj = jnp().asarray(demands, jnp().int32)
    nj = jnp().asarray(nodes, jnp().int32)
    a = P.place_lifecycle_shortlist(fp, np.asarray(demands), np.asarray(
        nodes), shortlist=shortlist, **kw)
    _same(a, ref.placement.place_lifecycle_shortlist(
        fr, dj, nj, shortlist=shortlist, **kw))
    kw.pop("eager_sweep", None)
    b = P.place_lifecycle_full_rerank(fp, np.asarray(demands),
                                      np.asarray(nodes), **kw)
    _same(b, ref.placement.place_lifecycle_full_rerank(fr, dj, nj, **kw))
    np.testing.assert_array_equal(a.node.numpy(), b.node.numpy())
    return a, b


@pytest.mark.parametrize("n", [5, 64, 1000, 1025, 2048])
@pytest.mark.parametrize("shortlist", [1, 4, 32])
def test_parity_ragged_n(n, shortlist):
    ref = load_reference()
    fr = ref.fleet.synthetic_fleet(n, seed=n)
    demands = np.random.default_rng(n).integers(1, 96, 48)
    _check(fr, demands, shortlist=shortlist)


def test_parity_shortlist_larger_than_fleet():
    ref = load_reference()
    a, _ = _check(ref.fleet.synthetic_fleet(17, seed=3), [4] * 24,
                  shortlist=4096)
    assert a.n_sweeps == 1


def test_parity_under_exact_ties():
    a, _ = _check(_uniform_fleet(100), [3] * 40, shortlist=8)
    assert int(a.node[0]) == 0 and bool((a.node >= 0).all())


def test_parity_capacity_exhaustion_and_unplaceable():
    a, _ = _check(_uniform_fleet(6, chips=4, cap=4), [3] * 10, shortlist=2)
    assert int(a.node.min()) == -1


def test_parity_all_infeasible():
    a, _ = _check(_uniform_fleet(32, cap=0), [1] * 5, shortlist=4)
    assert bool((a.node == -1).all()) and a.n_sweeps == 0


def test_shortlist_reduces_sweeps():
    ref = load_reference()
    a, b = _check(ref.fleet.synthetic_fleet(2048, seed=1), [64] * 128,
                  shortlist=64)
    assert b.n_sweeps == 128 and a.n_sweeps * 5 <= b.n_sweeps


def _random_event_stream(fp, rng, n_events, max_d=96):
    """Arrivals interleaved with releases of previously placed jobs,
    replayed against the oracle's scoring so releases stay consistent."""
    cap = fp.capacity.numpy().astype(np.int64).copy()
    healthy = fp.healthy.numpy()
    ctx = P.frozen_ctx(fp)
    live, demands, nodes = [], [], []
    for _ in range(n_events):
        if live and rng.random() < 0.4:
            nd, ch = live.pop(int(rng.integers(0, len(live))))
            demands.append(-ch)
            nodes.append(nd)
            cap[nd] += ch
        else:
            d = int(rng.integers(1, max_d))
            demands.append(d)
            nodes.append(-1)
            scores = P._ctx_scores(torch.from_numpy(cap), ctx,
                                   P.RankWeights()).numpy()
            masked = np.where((cap >= d) & healthy, scores, np.inf)
            best = int(np.argmin(masked))
            if np.isfinite(masked[best]):
                cap[best] -= d
                live.append((best, d))
    return demands, nodes


@pytest.mark.parametrize("n", [7, 64, 1000, 2048])
@pytest.mark.parametrize("shortlist", [2, 8, 32])
def test_lifecycle_parity_interleaved(n, shortlist):
    ref = load_reference()
    fr = ref.fleet.synthetic_fleet(n, seed=n + 1)
    rng = np.random.default_rng(n * 31 + shortlist)
    demands, nodes = _random_event_stream(port_fleet(fr), rng, 64)
    assert any(d < 0 for d in demands)
    _check(fr, demands, nodes, shortlist=shortlist)


def test_lifecycle_parity_under_ties_and_exhaustion():
    demands = [4] * 16 + [4, -4, -4, 4, 4, 4]
    nodes = [-1] * 16 + [-1, 3, 11, -1, -1, -1]
    a, _ = _check(_uniform_fleet(16, chips=4, cap=4), demands, nodes,
                  shortlist=4)
    out = a.node.numpy()
    assert out[16] == -1 and out[19] == 3 and out[20] == 11 and out[21] == -1


def test_lifecycle_release_outside_shortlist_invalidates():
    a, _ = _check(_uniform_fleet(64, chips=8, cap=8), [8] * 64 + [-8, 8],
                  [-1] * 64 + [50, -1], shortlist=2)
    assert a.node[-2] == 50 and a.node[-1] == 50


def test_lifecycle_migration_pattern():
    ref = load_reference()
    fr = ref.fleet.synthetic_fleet(256, seed=5)
    rng = np.random.default_rng(9)
    demands, nodes, placed = [], [], []
    for d in rng.integers(1, 64, 24):
        demands.append(int(d))
        nodes.append(-1)
        placed.append(int(d))
    for _ in range(8):
        d = placed.pop()
        demands += [-d, d]
        nodes += [int(rng.integers(0, 256)), -1]
    _check(fr, demands, nodes, shortlist=16)


def test_unhealthy_nodes_hard_masked():
    ref = load_reference()
    fr = ref.fleet.synthetic_fleet(128, seed=4)
    assert not np.asarray(fr.healthy).all()
    a, _ = _check(fr, [1] * 64, shortlist=4)
    healthy = np.asarray(fr.healthy)
    assert all(healthy[nd] for nd in a.node.numpy() if nd >= 0)


def test_eager_sweep_capacity_and_n_events():
    """The scan driver's event contract: eager first sweep, a starting
    capacity split from the scoring snapshot, a truncated event loop."""
    ref = load_reference()
    fr = ref.fleet.synthetic_fleet(300, seed=8)
    cap = np.minimum(np.asarray(fr.capacity) + 16, 256).astype(np.int32)
    demands = list(np.random.default_rng(3).integers(8, 64, 30)) + [0] * 2
    _check(fr, demands, shortlist=8, eager_sweep=True,
           capacity=None, n_events=None)
    fp = port_fleet(fr)
    kw_p = dict(capacity=torch.from_numpy(cap), n_events=24)
    kw_j = dict(capacity=jnp().asarray(cap), n_events=jnp().int32(24))
    for eager in (False, True):
        a = P.place_lifecycle_shortlist(fp, demands, [-1] * 32,
                                        shortlist=8, eager_sweep=eager,
                                        **kw_p)
        _same(a, ref.placement.place_lifecycle_shortlist(
            fr, jnp().asarray(demands, jnp().int32),
            jnp().full((32,), -1, jnp().int32), shortlist=8,
            eager_sweep=eager, **kw_j))
        assert (a.node[24:] == -1).all()
    b = P.place_lifecycle_full_rerank(fp, demands, [-1] * 32, **kw_p)
    _same(b, ref.placement.place_lifecycle_full_rerank(
        fr, jnp().asarray(demands, jnp().int32),
        jnp().full((32,), -1, jnp().int32), **kw_j))


@pytest.mark.parametrize("kind", ["plain", "energy"])
def test_kernel_sweep_path_matches_reference_kernel_path(kind):
    """``use_kernel=True`` (the plain K2 twin on the CPU) against the JAX
    engine's Pallas path in interpret mode: same nodes, same sweeps."""
    ref = load_reference()
    fr = ref.fleet.synthetic_fleet(96, seed=5)
    fp = port_fleet(fr)
    em_p = em_r = None
    if kind == "energy":
        from repro_torch.core.energy import EnergyModel
        em_r = ref.energy.EnergyModel().device(w_marginal=0.0)
        em_p = EnergyModel().device(w_marginal=0.0, device="cpu")
    demands = [8] * 16
    a = P.place_jobs_shortlist(fp, demands, shortlist=8, use_kernel=True,
                               energy=em_p)
    b = ref.placement.place_jobs_shortlist(
        fr, jnp().asarray(demands, jnp().int32), shortlist=8,
        use_kernel=True, interpret=True, energy=em_r)
    np.testing.assert_array_equal(a.node.numpy(), np.asarray(b.node))
    np.testing.assert_array_equal(a.capacity.numpy(), np.asarray(b.capacity))
    assert a.n_sweeps == int(b.n_sweeps)
    c = P.place_jobs_shortlist(fp, demands, shortlist=8, energy=em_p)
    np.testing.assert_array_equal(a.node.numpy(), c.node.numpy())


@pytest.mark.parametrize("engine", ["shortlist", "full", "auto"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_scheduler_place_jobs_and_events_match_reference(engine,
                                                         use_kernel):
    ref = load_reference()
    fr = ref.fleet.synthetic_fleet(256, seed=9)
    fp = port_fleet(fr)
    demands = [16] * 32
    a = scheduler.place_jobs(fp, demands, engine=engine, shortlist=16,
                             use_kernel=use_kernel)
    b = ref.scheduler.place_jobs(fr, jnp().asarray(demands, jnp().int32),
                                 engine=engine, shortlist=16,
                                 use_kernel=use_kernel)
    np.testing.assert_array_equal(a.node.numpy(), np.asarray(b.node))
    assert a.n_sweeps == int(b.n_sweeps)
    # lifecycle wrapper: arrival, arrival, release, arrival, no-op
    n0 = int(a.node[0])
    ev = [8, 8, -8, 8, 0]
    nodes = [-1, -1, n0, -1, -1]
    c = scheduler.place_events(fp, ev, nodes, engine=engine, shortlist=8,
                               use_kernel=use_kernel)
    d = ref.scheduler.place_events(fr, jnp().asarray(ev, jnp().int32),
                                   jnp().asarray(nodes, jnp().int32),
                                   engine=engine, shortlist=8,
                                   use_kernel=use_kernel,
                                   interpret=True if use_kernel else None)
    np.testing.assert_array_equal(c.node.numpy(), np.asarray(d.node))
    assert c.n_sweeps == int(d.n_sweeps)
    assert int(c.node[2]) == n0 and int(c.node[4]) == -1
    with pytest.raises(ValueError):
        scheduler.place_jobs(fp, demands, engine="bogus")
    with pytest.raises(ValueError):
        scheduler.place_events(fp, ev, nodes, engine="bogus")


def test_auto_engine_keys_on_device_type():
    assert scheduler._auto_engine(4096, 256, device_type="cuda") == \
        "shortlist"
    assert scheduler._auto_engine(4096, 256) == "full"
    assert scheduler._auto_engine(10 ** 8, 256) == "shortlist"
