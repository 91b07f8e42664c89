"""Port vs JAX reference: telemetry, Eq. 2 accounting, the energy model,
Eq. 1 ranking, the fleet, and the placement engine's frozen scoring
context — all on the CPU, inputs made from a seed with numpy."""
import numpy as np
import pytest
import torch

from test_torch_reference import (bits, jnp, load_reference, port_fleet,
                                  reference_imports)

from repro_torch import convert
from repro_torch.core import (carbon, energy, fleet, placement, ranking,
                              telemetry)


@pytest.mark.parametrize("hours,seed", [(400, 2022), (25, 7), (3, 1)])
def test_hourly_ci_and_region_traces_bit_identical(hours, seed):
    ref = load_reference()
    for name in telemetry.REGIONS:
        a = telemetry.hourly_ci(telemetry.REGIONS[name], hours, seed)
        b = ref.telemetry.hourly_ci(ref.telemetry.REGIONS[name], hours, seed)
        np.testing.assert_array_equal(a, b)
    ci, pue = telemetry.region_traces(hours, seed)
    ci_r, pue_r = ref.telemetry.region_traces(hours, seed)
    np.testing.assert_array_equal(ci, ci_r)
    np.testing.assert_array_equal(pue, pue_r)


def test_carbon_accounting_matches_reference():
    ref = load_reference()
    rng = np.random.default_rng(0)
    p = rng.random((3, 48)).astype(np.float32) * 400
    ci = rng.random((3, 48)).astype(np.float32) * 500
    pue = (1 + rng.random((3, 1))).astype(np.float32)
    got = carbon.emissions_g(torch.from_numpy(p), torch.from_numpy(pue),
                             torch.from_numpy(ci))
    want = ref.carbon.emissions_g(jnp().asarray(p), jnp().asarray(pue),
                                  jnp().asarray(ci))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert carbon.job_energy_kwh(3600.0, 2, 16) == \
        float(ref.carbon.job_energy_kwh(3600.0, 2, 16))
    e = torch.from_numpy(rng.random(8).astype(np.float32))
    np.testing.assert_array_equal(
        bits(carbon.carbon_footprint(e, 1.25, 300.0)),
        bits(ref.carbon.carbon_footprint(jnp().asarray(e.numpy()), 1.25,
                                         300.0)))


@pytest.mark.parametrize("kw", [{}, dict(idle_frac=0.2, w_marginal=0.3,
                                         embodied_g_per_node_h=120.0)])
def test_energy_model_matches_reference(kw):
    ref = load_reference()
    a = energy.EnergyModel(**kw)
    b = ref.energy.EnergyModel(**kw)
    assert convert.energy_from_numpy(b) == a
    for attr in ("e_kwh_h", "chip_kw", "watts_per_chip", "dyn_frac"):
        assert getattr(a, attr) == getattr(b, attr), attr
    assert a.ckpt_kwh(0.05) == b.ckpt_kwh(0.05)
    assert a.node_kw(8) == b.node_kw(8)
    da, db = a.device(device="cpu"), b.device()
    for f in ("idle_frac", "dyn_frac", "embodied_g_per_node_h",
              "w_marginal", "chip_power_w", "host_power_w"):
        assert getattr(da, f).dtype == torch.float32
        assert bits(getattr(da, f)) == bits(getattr(db, f)), f
    with pytest.raises(NotImplementedError, match="item 11"):
        a.for_workload(None, None)


@pytest.mark.parametrize("n", [3, 64, 1000])
def test_maiz_ranking_and_rank_nodes_match_reference(n):
    ref = load_reference()
    rng = np.random.default_rng(n)
    cols = [rng.random(n).astype(np.float32) * s for s in (400, 300, 1, 1)]
    # exact ties across half the candidates
    cols[0][: n // 2] = cols[0][0]
    w = ranking.RankWeights(w1=0.4, w2=0.2, w3=0.3, w4=0.1, marginal=0.25)
    wr = ref.ranking.RankWeights(w1=0.4, w2=0.2, w3=0.3, w4=0.1,
                                 marginal=0.25)
    assert convert.weights_from(wr) == w
    mc = rng.random(n).astype(np.float32)
    got = ranking.maiz_ranking(*map(torch.from_numpy, cols), w,
                               marginal_cfp=torch.from_numpy(mc))
    want = ref.ranking.maiz_ranking(*map(jnp().asarray, cols), wr,
                                    marginal_cfp=jnp().asarray(mc))
    np.testing.assert_array_equal(bits(got), bits(want))
    valid = rng.random(n) > 0.3
    order, best = ranking.rank_nodes(got, torch.from_numpy(valid))
    order_r, best_r = ref.ranking.rank_nodes(want, jnp().asarray(valid))
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_r))
    assert int(best) == int(best_r)
    off = torch.from_numpy(valid)
    ct = torch.full((n,), 64, dtype=torch.int32)
    np.testing.assert_array_equal(
        bits(ranking.marginal_cfp(got, ct, 0.35, 0.65, off, 12.0, 2.0)),
        bits(ref.ranking.marginal_cfp(want, jnp().asarray(ct.numpy()), 0.35,
                                      0.65, jnp().asarray(valid), 12.0,
                                      2.0)))


@pytest.mark.parametrize("n,seed,hour", [(5, 0, 0), (1025, 3, 7),
                                         (2048, 11, 30)])
def test_synthetic_fleet_bit_identical(n, seed, hour):
    ref = load_reference()
    a = fleet.synthetic_fleet(n, seed=seed, hour=hour, device="cpu")
    b = ref.fleet.synthetic_fleet(n, seed=seed, hour=hour)
    for f in fleet.FIELDS:
        x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("marginal", [False, True])
def test_fleet_terms_and_rank_match_reference(marginal):
    ref = load_reference()
    fr = ref.fleet.synthetic_fleet(777, seed=4)
    fp = port_fleet(fr)
    em_r = ref.energy.EnergyModel(idle_frac=0.2, w_marginal=0.3) \
        if marginal else None
    em_p = convert.energy_from_numpy(em_r) if marginal else None
    w = ranking.RankWeights(marginal=0.3 if marginal else 0.0)
    wr = ref.ranking.RankWeights(marginal=0.3 if marginal else 0.0)
    cap = np.random.default_rng(1).integers(0, 257, 777).astype(np.int32)
    for x, y in zip(fp.raw_terms(horizon_h=2.0, capacity=torch.from_numpy(
            cap), energy=em_p), fr.raw_terms(horizon_h=2.0, capacity=jnp(
            ).asarray(cap), energy=em_r)):
        np.testing.assert_array_equal(bits(x), bits(y))
    got = fp.rank(weights=w, demand_chips=40, energy=em_p)
    with reference_imports():       # Fleet.rank imports marginal_cfp lazily
        want = fr.rank(weights=wr, demand_chips=40, energy=em_r)
    np.testing.assert_array_equal(bits(got), bits(want))


def _ctx_case(kind):
    ref = load_reference()
    fr = ref.fleet.synthetic_fleet(1500, seed=9)
    w, wr = ranking.RankWeights(), ref.ranking.RankWeights()
    em_p = em_r = None
    if kind == "energy":
        em_r = ref.energy.EnergyModel(idle_frac=0.3, w_marginal=0.2,
                                      embodied_g_per_node_h=40.0).device()
        em_p = convert.energy_from_numpy(
            {k: np.asarray(getattr(em_r, k)) for k in
             ("idle_frac", "chip_power_w", "host_power_w",
              "embodied_g_per_node_h", "w_marginal", "dyn_frac",
              "chips_per_host")}).device(device="cpu")
    elif kind == "marginal":
        w = ranking.RankWeights(marginal=0.4)
        wr = ref.ranking.RankWeights(marginal=0.4)
    elif kind == "odd_chips":
        # chips_total not a power of two: the reciprocal is rounded
        arrs = {f: np.asarray(getattr(fr, f)) for f in fleet.FIELDS}
        ct = np.random.default_rng(2).integers(1, 300, 1500).astype(np.int32)
        arrs["chips_total"] = ct
        arrs["capacity"] = np.minimum(arrs["capacity"], ct)
        fr = ref.fleet.Fleet(**{f: jnp().asarray(v) for f, v in
                                arrs.items()})
    return ref, fr, port_fleet(fr), w, wr, em_p, em_r


@pytest.mark.parametrize("kind", ["default", "marginal", "energy",
                                  "odd_chips"])
def test_frozen_ctx_and_ctx_scores_bitwise(kind):
    ref, fr, fp, w, wr, em_p, em_r = _ctx_case(kind)
    ctx = placement.frozen_ctx(fp, w, 1.0, energy=em_p)
    ctx_r = ref.placement.frozen_ctx(fr, wr, 1.0, energy=em_r)
    assert set(ctx) == set(ctx_r)
    for k in ctx:
        np.testing.assert_array_equal(bits(ctx[k]), bits(ctx_r[k]),
                                      err_msg=k)
    cap = np.random.default_rng(5).integers(0, 257, fp.n).astype(np.int32)
    cap = np.minimum(cap, fp.chips_total.numpy())
    got = placement._ctx_scores(torch.from_numpy(cap), ctx, w)
    want = ref.placement._ctx_scores(jnp().asarray(cap), ctx_r, wr)
    np.testing.assert_array_equal(bits(got), bits(want))
    # the O(1) rescore is bitwise the sweep's value (and the reference's)
    for b in (0, 17, fp.n - 1):
        one = placement._one_score(int(cap[b]), b, ctx, w)
        assert bits(np.float32(one)) == bits(got[b])
        assert bits(np.float32(one)) == bits(ref.placement._one_score(
            jnp().asarray(cap[b]), b, ctx_r, wr))
