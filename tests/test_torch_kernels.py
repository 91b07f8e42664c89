"""The rank kernels' plain torch twins (the CPU path of K1 ``maiz_lohi``
and K2 ``maiz_topk``) vs the JAX Pallas kernels in interpret mode and the
reference oracles.  The CUDA kernels themselves are held against these
twins on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_reference import bits, jnp, load_reference

from repro_torch.kernels import maizx_rank as mr
from repro_torch.kernels import ops, ref as kref

W4 = np.asarray([0.35, 0.25, 0.25, 0.15], np.float32)


def _streams(rng, n, marginal):
    """Random node streams (f32 numpy); marginal adds pk/cap/ct with some
    nodes fully free (cap == ct, the wake branch)."""
    s = [rng.random(n) * 100, 1 + rng.random(n), rng.random(n) * 500,
         rng.random(n) * 500, rng.random(n), rng.random(n)]
    s = [x.astype(np.float32) for x in s]
    if not marginal:
        return s, None
    ct = rng.choice([64.0, 96.0, 128.0], n).astype(np.float32)
    cap = np.where(rng.random(n) < 0.3, ct,
                   np.floor(rng.random(n).astype(np.float32) * ct))
    return s, [(rng.random(n) * 8).astype(np.float32),
               cap.astype(np.float32), ct]


def _pad(x, pad):
    return F.pad(x.to(torch.float32), (0, pad))


def _both(streams, extra, en, dtype):
    """(port kwargs/args padded, jax args padded) from numpy streams."""
    n = streams[0].shape[0]
    pad = (-n) % mr.TILE
    tt = [torch.from_numpy(x).to(dtype) for x in streams]
    jj = [jnp().asarray(x, jnp().bfloat16 if dtype == torch.bfloat16
                        else jnp().float32) for x in streams]
    args_p = [_pad(x, pad) for x in tt]
    args_j = [jnp().pad(x.astype(jnp().float32), (0, pad)) for x in jj]
    kw_p, kw_j = {}, {}
    if en is not None:
        pk, cap, ct = extra
        kw_p = dict(pk=_pad(torch.from_numpy(pk), pad),
                    cap=_pad(torch.from_numpy(cap), pad),
                    ct=_pad(torch.from_numpy(ct), pad),
                    en=torch.from_numpy(en))
        kw_j = dict(pk=jnp().pad(jnp().asarray(pk), (0, pad)),
                    cap=jnp().pad(jnp().asarray(cap), (0, pad)),
                    ct=jnp().pad(jnp().asarray(ct), (0, pad)),
                    en=jnp().asarray(en))
    return n, tt, jj, args_p, args_j, kw_p, kw_j


EN = np.asarray([0.35, 0.65, 120.0, 0.3], np.float32)


@pytest.mark.parametrize("n", [96, 1024, 3000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("marginal", [False, True], ids=["4term", "5term"])
def test_k1_plain_matches_pallas_and_oracle_exactly(n, dtype, marginal):
    ref = load_reference()
    rng = np.random.default_rng(n + marginal)
    s, extra = _streams(rng, n, marginal)
    en = EN if marginal else None
    n, tt, jj, args_p, args_j, kw_p, kw_j = _both(s, extra, en, dtype)
    got = mr.maiz_lohi(*args_p, n, **kw_p)
    assert got.shape == (5 if marginal else 4, 2)
    want = ref.maizx_rank.maiz_lohi_pallas(
        *args_j, jnp().full((1, 1), n, jnp().int32), interpret=True, **kw_j)
    np.testing.assert_array_equal(bits(got), bits(want))
    okw_p = okw_j = {}
    if marginal:
        okw_p = dict(pk=torch.from_numpy(extra[0]),
                     cap=torch.from_numpy(extra[1]),
                     chips_total=torch.from_numpy(extra[2]),
                     en=torch.from_numpy(en))
        okw_j = {k: jnp().asarray(v.numpy()) for k, v in okw_p.items()}
    oracle = ref.kref.term_lohi(*jj, **okw_j)
    np.testing.assert_array_equal(bits(got), bits(oracle))
    np.testing.assert_array_equal(bits(kref.term_lohi(*tt, **okw_p)),
                                  bits(oracle))


@pytest.mark.parametrize("n,k", [(1024, 8), (3000, 1), (2050, 8),
                                 (96, 65), (2048, 65), (5, 8)])
@pytest.mark.parametrize("marginal", [False, True], ids=["4term", "5term"])
def test_k2_plain_matches_pallas(n, k, marginal):
    """Scores within the JAX suite's own bar, tile candidates and the merged
    top-k node ids exact.  k=65 is above the reference's tile cap (64), so
    the reference merges it from the full score vector while the port
    (cap 128) merges tile candidates; the Pallas kernel runs at its own cap
    and the port's first 64 candidates of each tile are held against it."""
    ref = load_reference()
    rng = np.random.default_rng(7 * n + k)
    s, extra = _streams(rng, n, marginal)
    en = EN if marginal else None
    n, tt, jj, args_p, args_j, kw_p, kw_j = _both(s, extra, en,
                                                  torch.float32)
    lohi = mr.maiz_lohi(*args_p, n, **kw_p)
    k_tile = min(k, n, mr.MAX_TILE_K)
    k_ref = min(k, n, ref.maizx_rank.MAX_TILE_K)
    sc, tmin, targ = mr.maiz_topk(*args_p, n, lohi, torch.from_numpy(W4),
                                  k=k_tile, **kw_p)
    sc_j, tmin_j, targ_j = ref.maizx_rank.maiz_topk_pallas(
        *args_j, jnp().full((1, 1), n, jnp().int32), jnp().asarray(
            lohi.numpy()), jnp().asarray(W4), k=k_ref, interpret=True,
        **kw_j)
    np.testing.assert_allclose(sc.numpy(), np.asarray(sc_j), atol=1e-5)
    np.testing.assert_array_equal(targ[:, :k_ref].numpy(),
                                  np.asarray(targ_j))
    np.testing.assert_allclose(tmin[:, :k_ref].numpy(), np.asarray(tmin_j),
                               atol=1e-5)
    okw_p = okw_j = {}
    if marginal:
        okw_p = dict(pk=torch.from_numpy(extra[0]),
                     cap=torch.from_numpy(extra[1]),
                     chips_total=torch.from_numpy(extra[2]),
                     en=torch.from_numpy(en))
        okw_j = {k_: jnp().asarray(v.numpy()) for k_, v in okw_p.items()}
    scores, top_s, top_i = ops.maiz_ranking_topk(
        *tt, torch.from_numpy(W4), k=k, **okw_p)
    scores_j, top_s_j, top_i_j = ref.ops.maiz_ranking_topk(
        *jj, jnp().asarray(W4), k=k, interpret=True, **okw_j)
    assert top_i.dtype == torch.int32 and top_i.shape == (min(k, n),)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(top_i_j))
    np.testing.assert_allclose(top_s.numpy(), np.asarray(top_s_j),
                               atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j),
                               atol=1e-5)
    # and against the plain oracle of the fused ranking
    want, _, want_arg = kref.maiz_ranking_ref(
        *tt, kref.term_lohi(*tt, **okw_p), torch.from_numpy(W4), **okw_p)
    np.testing.assert_array_equal(bits(scores), bits(want))
    assert int(top_i[0]) == int(want_arg)


def test_k2_ties_lowest_index_first():
    """Duplicate tiles -> exact ties across tiles; both copies enter the
    shortlist, lower index first, as in the reference."""
    ref = load_reference()
    rng = np.random.default_rng(7)
    base = rng.random(1024).astype(np.float32)
    ci = np.tile(rng.random(1024).astype(np.float32), 2)
    n = 2048
    cols = [np.tile(base, 2), np.ones(n, np.float32), ci, ci,
            np.zeros(n, np.float32), np.zeros(n, np.float32)]
    _, top_s, top_i = ops.maiz_ranking_topk(
        *map(torch.from_numpy, cols), torch.from_numpy(W4), k=8)
    _, top_s_j, top_i_j = ref.ops.maiz_ranking_topk(
        *map(jnp().asarray, cols), jnp().asarray(W4), k=8, interpret=True)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(top_i_j))
    np.testing.assert_array_equal(bits(top_s), bits(top_s_j))
    ti, ts = top_i.numpy(), top_s.numpy()
    for v in np.unique(ts):
        dup = ti[ts == v]
        assert dup.size == 2 and dup[0] < 1024 <= dup[1]


def test_k2_tile_with_fewer_than_k_finite_scores():
    """A tile holding fewer than k valid nodes: after the finite scores the
    extraction keeps re-selecting the lowest id holding +inf — the
    reference's literal rule, reproduced by the twin."""
    ref = load_reference()
    rng = np.random.default_rng(3)
    s, _ = _streams(rng, 2048, False)
    n_valid = 1030                      # tile 1 holds 6 valid nodes
    args_p = [torch.from_numpy(x) for x in s]
    args_j = [jnp().asarray(x) for x in s]
    lohi = mr.maiz_lohi(*args_p, n_valid)
    _, tmin, targ = mr.maiz_topk(*args_p, n_valid, lohi,
                                 torch.from_numpy(W4), k=10)
    _, tmin_j, targ_j = ref.maizx_rank.maiz_topk_pallas(
        *args_j, jnp().full((1, 1), n_valid, jnp().int32),
        jnp().asarray(lohi.numpy()), jnp().asarray(W4), k=10,
        interpret=True)
    np.testing.assert_array_equal(targ.numpy(), np.asarray(targ_j))
    # interpret-mode scores sit a few ulp from the plain ones (the JAX
    # suite's own 1e-5 bar); the +inf tail is exact
    np.testing.assert_allclose(tmin.numpy(), np.asarray(tmin_j), atol=1e-5)
    assert np.isinf(tmin[1, 6:].numpy()).all()
    assert len(set(targ[1, 6:].tolist())) == 1


def test_k2_marginal_weight_zero_is_bitwise_four_term():
    rng = np.random.default_rng(11)
    s, extra = _streams(rng, 2048, True)
    tt = [torch.from_numpy(x) for x in s]
    en0 = torch.tensor([0.35, 0.65, 120.0, 0.0])
    s4, t4, i4 = ops.maiz_ranking_topk(*tt, torch.from_numpy(W4), k=16)
    s5, t5, i5 = ops.maiz_ranking_topk(
        *tt, torch.from_numpy(W4), k=16, pk=torch.from_numpy(extra[0]),
        cap=torch.from_numpy(extra[1]), chips_total=torch.from_numpy(
            extra[2]), en=en0)
    np.testing.assert_array_equal(bits(s4), bits(s5))
    np.testing.assert_array_equal(bits(t4), bits(t5))
    np.testing.assert_array_equal(i4.numpy(), i5.numpy())


@pytest.mark.parametrize("k", [65, 100, 128])
@pytest.mark.parametrize("n", [100, 1100, 3000])
@pytest.mark.parametrize("marginal", [False, True], ids=["4term", "5term"])
def test_merged_topk_above_the_reference_tile_cap(n, k, marginal):
    """Shortlists of 65-128 merge the port's tile candidates (cap 128); the
    reference merges them from the full score vector (its cap is 64).  Node
    ids equal the reference's, scores within the suite's 1e-5, and both
    equal the port's own full-vector route bit for bit, short tiles
    included (n = 1100 leaves 76 valid nodes in tile 1)."""
    ref = load_reference()
    rng = np.random.default_rng(n + k + marginal)
    s, extra = _streams(rng, n, marginal)
    tt = [torch.from_numpy(x) for x in s]
    jj = [jnp().asarray(x) for x in s]
    okw_p = okw_j = {}
    if marginal:
        okw_p = dict(pk=torch.from_numpy(extra[0]),
                     cap=torch.from_numpy(extra[1]),
                     chips_total=torch.from_numpy(extra[2]),
                     en=torch.from_numpy(EN))
        okw_j = {a: jnp().asarray(b.numpy()) for a, b in okw_p.items()}
    w = torch.from_numpy(W4)
    scores, top_s, top_i = ops.maiz_ranking_topk(*tt, w, k=k, **okw_p)
    k_out = min(k, n)
    assert top_i.shape == (k_out,) and top_i.dtype == torch.int32
    full_s, full_i = ops.lex_head(scores, k_out)
    np.testing.assert_array_equal(bits(top_s), bits(full_s))
    np.testing.assert_array_equal(top_i.numpy(), full_i.numpy())
    _, top_s_j, top_i_j = ref.ops.maiz_ranking_topk(
        *jj, jnp().asarray(W4), k=k, interpret=True, **okw_j)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(top_i_j))
    np.testing.assert_allclose(top_s.numpy(), np.asarray(top_s_j),
                               atol=1e-5)
    # the batched route merges its lanes' candidates the same way
    args_b = [torch.stack([x, x.flip(0)]) for x in tt]
    kw_b = {a: (torch.stack([b, b]) if a == "en" else
                torch.stack([b, b.flip(0)])) for a, b in okw_p.items()}
    sb, tsb, tib = ops.maiz_ranking_topk_batched(*args_b, w, k=k, **kw_b)
    fs, fi = ops.lex_head(sb, k_out)
    np.testing.assert_array_equal(bits(tsb), bits(fs))
    np.testing.assert_array_equal(tib.numpy(), fi.numpy())
    np.testing.assert_array_equal(tib[0].numpy(), top_i.numpy())


def test_tile_topk_prefix_is_the_smaller_k():
    """The k-round extraction is prefix-consistent: a tile's top-k_small is
    the first k_small of its top-k, up to the port's cap of 128 (what lets
    the Pallas comparison at the reference's cap hold the port's first 64
    candidates)."""
    rng = np.random.default_rng(5)
    s, _ = _streams(rng, 3000, False)
    args = [_pad(torch.from_numpy(x), 72) for x in s]
    lohi = mr.maiz_lohi(*args, 3000)
    w = torch.from_numpy(W4)
    _, tmin, targ = mr.maiz_topk(*args, 3000, lohi, w, k=mr.MAX_TILE_K)
    for k in (1, 2, 64, 65):
        _, tm, ta = mr.maiz_topk(*args, 3000, lohi, w, k=k)
        np.testing.assert_array_equal(bits(tm), bits(tmin[:, :k]))
        np.testing.assert_array_equal(ta.numpy(), targ[:, :k].numpy())


def test_fused_ranking_head_and_tile_k_limit():
    rng = np.random.default_rng(1)
    s, _ = _streams(rng, 1500, False)
    tt = [torch.from_numpy(x) for x in s]
    scores, best_s, best_n = ops.maiz_ranking_fused(*tt, torch.from_numpy(W4))
    assert int(best_n) == int(torch.argmin(scores))
    assert bits(best_s) == bits(scores[int(best_n)])
    with pytest.raises(ValueError, match="MAX_TILE_K") as ei:
        mr.maiz_topk(*[torch.ones(1024)] * 6, 1024, torch.zeros(4, 2),
                     torch.from_numpy(W4), k=mr.MAX_TILE_K + 1)
    assert "shortlist" in str(ei.value)


def test_cpu_path_never_counts_kernel_launches():
    """CPU tensors take the plain twin; only kernel launches count."""
    mr.reset_launch_counts()
    rng = np.random.default_rng(2)
    s, _ = _streams(rng, 1024, False)
    ops.maiz_ranking_fused(*[torch.from_numpy(x) for x in s],
                           torch.from_numpy(W4))
    assert mr.maiz_lohi.launches == 0 and mr.maiz_topk.launches == 0


# ---------------------------------------------------------------------------
# K3 / K4: the batched twins over a leading lane axis
# ---------------------------------------------------------------------------


def _ulps(a, b) -> int:
    """Largest distance in f32 units in the last place (0 = bitwise)."""
    a = bits(a).astype(np.int64)
    b = bits(b).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max())


def _within_ulps_of_one(a, b, ulps=2):
    """Equal infinities, finite values within ``ulps`` f32 ulps of 1.0:
    the scores are weighted sums of terms normalized to [0, 1], so the
    reference kernel's rounding gap is an absolute one (up to 4 ulp of a
    0.03 score, ROADMAP Queue 3)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    fin = np.isfinite(b)
    np.testing.assert_array_equal(a[~fin], b[~fin])
    assert np.abs(a[fin] - b[fin]).max() <= ulps * np.finfo(np.float32).eps


def _lanes(rng, L, n, marginal, w_m):
    """(L, N) streams plus per-lane en rows (other idle/embodied per lane,
    the same w_m)."""
    per = [_streams(rng, n, marginal) for _ in range(L)]
    s = [np.stack([p[0][i] for p in per]) for i in range(6)]
    extra = en = None
    if marginal:
        extra = [np.stack([p[1][i] for p in per]) for i in range(3)]
        en = np.asarray([[0.35, 0.65, 120.0, w_m], [0.25, 0.75, 0.0, w_m],
                         [0.4, 0.6, 30.0, w_m]], np.float32)[:L]
    return s, extra, en


@pytest.mark.parametrize("n", [2048, 3000])
@pytest.mark.parametrize("variant", ["4term", "5term_wm0", "5term_wm"])
def test_k3_k4_plain_per_lane_and_against_pallas(n, variant):
    """L = 3 lanes: each lane of the K3/K4 twins is bitwise the sequential
    K1/K2 twins on that lane and the reference oracles; against the
    reference's batched Pallas kernels in interpret mode, K3 is exact and
    K4 within 2 ulp with tile candidate ids exact (the gap is the
    reference kernel's own, ROADMAP Queue 3)."""
    ref = load_reference()
    L, k = 3, 8
    marginal = variant != "4term"
    rng = np.random.default_rng(n + len(variant))
    s, extra, en = _lanes(rng, L, n, marginal, 0.3 if variant ==
                          "5term_wm" else 0.0)
    pad = (-n) % mr.TILE
    args_p = [_pad(torch.from_numpy(x), pad) for x in s]
    args_j = [jnp().pad(jnp().asarray(x), ((0, 0), (0, pad))) for x in s]
    kw_p = kw_j = {}
    if marginal:
        kw_p = dict(pk=_pad(torch.from_numpy(extra[0]), pad),
                    cap=_pad(torch.from_numpy(extra[1]), pad),
                    ct=_pad(torch.from_numpy(extra[2]), pad),
                    en=torch.from_numpy(en))
        kw_j = dict(pk=jnp().pad(jnp().asarray(extra[0]), ((0, 0), (0, pad))),
                    cap=jnp().pad(jnp().asarray(extra[1]), ((0, 0), (0, pad))),
                    ct=jnp().pad(jnp().asarray(extra[2]), ((0, 0), (0, pad))),
                    en=jnp().asarray(en))
    n_valid = jnp().full((1, 1), n, jnp().int32)
    lohi = mr.maiz_lohi_b(*args_p, n, **kw_p)
    assert lohi.shape == (L, 5 if marginal else 4, 2)
    assert _ulps(lohi, ref.maizx_rank.maiz_lohi_pallas_b(
        *args_j, n_valid, interpret=True, **kw_j)) <= 1
    w = torch.from_numpy(W4)
    got = mr.maiz_topk_b(*args_p, n, lohi, w, k=k, **kw_p)
    sc_j, tmin_j, targ_j = ref.maizx_rank.maiz_topk_pallas_b(
        *args_j, n_valid, jnp().asarray(lohi.numpy()), jnp().asarray(W4),
        k=k, interpret=True, **kw_j)
    _within_ulps_of_one(got[0].numpy(), sc_j)
    _within_ulps_of_one(got[1].numpy(), tmin_j)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(targ_j))
    for l in range(L):
        lane_p = [x[l] for x in args_p]
        lkw = {a: (b[l]) for a, b in kw_p.items()}
        lohi_l = mr.maiz_lohi(*lane_p, n, **lkw)
        np.testing.assert_array_equal(bits(lohi[l]), bits(lohi_l))
        for x, y in zip(got, mr.maiz_topk(*lane_p, n, lohi_l, w, k=k,
                                          **lkw)):
            np.testing.assert_array_equal(x[l].numpy().view(np.int32),
                                          y.numpy().view(np.int32))
        okw_p = okw_j = {}
        if marginal:
            okw_p = dict(pk=torch.from_numpy(extra[0][l]),
                         cap=torch.from_numpy(extra[1][l]),
                         chips_total=torch.from_numpy(extra[2][l]),
                         en=torch.from_numpy(en[l]))
            okw_j = {a: jnp().asarray(b.numpy()) for a, b in okw_p.items()}
        lane_j = [jnp().asarray(x[l]) for x in s]
        oracle_lohi = ref.kref.term_lohi(*lane_j, **okw_j)
        np.testing.assert_array_equal(bits(lohi[l]), bits(oracle_lohi))
        want, _, _ = ref.kref.maiz_ranking_ref(
            *lane_j, oracle_lohi, jnp().asarray(W4), **okw_j)
        np.testing.assert_array_equal(bits(got[0][l, :n]), bits(want))
        # the merged shortlist: one batched call == the sequential wrapper
        for kk in (16, 65, mr.MAX_TILE_K):
            a = ops.maiz_ranking_topk_batched(
                *[torch.from_numpy(x) for x in s], w, k=kk,
                **({} if not marginal else dict(
                    pk=torch.from_numpy(extra[0]),
                    cap=torch.from_numpy(extra[1]),
                    chips_total=torch.from_numpy(extra[2]),
                    en=torch.from_numpy(en))))
            b = ops.maiz_ranking_topk(*[torch.from_numpy(x[l]) for x in s],
                                      w, k=kk, **okw_p)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x[l].numpy().view(np.int32),
                                              y.numpy().view(np.int32))


def test_batched_wrappers_check_shapes_and_never_count_on_cpu():
    mr.reset_launch_counts()
    x = torch.ones(2, 1024)
    lohi = mr.maiz_lohi_b(*[x] * 6, 1024)
    mr.maiz_topk_b(*[x] * 6, 1024, lohi, torch.from_numpy(W4), k=4)
    assert all(f.launches == 0 for f in mr.WRAPPERS)
    with pytest.raises(ValueError, match=r"\(2, 4, 2\)"):
        mr.maiz_topk_b(*[x] * 6, 1024, lohi[:, :3], torch.from_numpy(W4),
                       k=4)
    with pytest.raises(ValueError, match=r"\(L, N\)"):
        mr.maiz_lohi_b(*[x[0]] * 6, 1024)
    with pytest.raises(ValueError, match="MAX_TILE_K"):
        mr.maiz_topk_b(*[x] * 6, 1024, lohi, torch.from_numpy(W4),
                       k=mr.MAX_TILE_K + 1)


# ---------------------------------------------------------------------------
# the fused K1/K3's fold: zero order and grid size (host side)
# ---------------------------------------------------------------------------


def _signed_zero_streams(n=4096):
    """+0.0 in one tile and -0.0 in another for the same term: the min of
    eff (term 2) and sched (term 3), the max of the two CFP terms (ec < 0
    makes them negative, so their max is a zero)."""
    rng = np.random.default_rng(5)
    s = [rng.random(n).astype(np.float32) + 1 for _ in range(6)]
    s[0] = -s[0]
    s[0][5], s[0][1024 + 9] = 0.0, -0.0
    s[4][100], s[4][2048 + 7] = 0.0, -0.0
    s[5][10], s[5][3000] = 0.0, -0.0
    return [torch.from_numpy(x) for x in s]


@pytest.mark.parametrize("n_valid,sched_lo_neg", [(4096, True),
                                                  (3000, False)])
def test_fold_orders_signed_zeros_across_tiles(n_valid, sched_lo_neg):
    """The fold keeps -0.0 as the min and +0.0 as the max of a zero, in
    any tile order, as the fused kernel does; K1's and K3's CPU routes
    fold so, lane by lane."""
    s = _signed_zero_streams()
    lohi = mr.maiz_lohi(*s, n_valid)
    sign = torch.signbit(lohi)
    assert bool((lohi[:2, 1] == 0).all()) and not bool(sign[:2, 1].any())
    assert float(lohi[2, 0]) == 0 and bool(sign[2, 0])
    assert float(lohi[3, 0]) == 0 and bool(sign[3, 0]) == sched_lo_neg
    lo, hi = mr.maiz_lohi_plain(*s, n_valid)
    for order in (torch.arange(4), torch.tensor([3, 1, 2, 0])):
        np.testing.assert_array_equal(
            bits(mr.fold_lohi(lo[order], hi[order])), bits(lohi))
    lanes = [torch.stack([x, x.flip(0)]) for x in s]
    got = mr.maiz_lohi_b(*lanes, n_valid)
    np.testing.assert_array_equal(bits(got[0]), bits(lohi))
    np.testing.assert_array_equal(
        bits(got[1]), bits(mr.maiz_lohi(*[x.flip(0) for x in s], n_valid)))


def test_fold_without_zeros_is_amin_amax():
    rng = np.random.default_rng(9)
    lo = torch.from_numpy(rng.standard_normal((3, 7, 5)).astype(np.float32))
    hi = torch.from_numpy(rng.standard_normal((3, 7, 5)).astype(np.float32))
    np.testing.assert_array_equal(
        bits(mr.fold_lohi(lo, hi)),
        bits(torch.stack([lo.amin(1), hi.amax(1)], -1)))


@pytest.mark.parametrize("lanes,n_valid,want", [
    (1, 1 << 20, 792), (1, 3000, 3), (1, 0, 1), (8, 65536, 64),
    (4, 1 << 20, 198), (2000, 1024, 1)])
def test_fused_grid_splits_the_resident_blocks(lanes, n_valid, want):
    """Blocks per lane: the resident blocks over the lanes, at most one
    per chunk of valid nodes, at least one (the occupancy is cached per
    device and term count)."""
    mr._RESIDENT[(0, 4)] = 792
    try:
        assert mr.lohi_blocks("cuda:0", 4, lanes, n_valid) == want
    finally:
        del mr._RESIDENT[(0, 4)]
