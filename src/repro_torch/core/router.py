"""Carbon-aware QPS router: marginal-carbon water-filling under p99 SLOs
(torch twin of ``repro.core.router``).

Splits each service's offered request load (``core.traffic``) across its
placed replicas by *marginal carbon* — the per-request operating rate
``EnergyModel.req_kwh · PUE · CI`` of the replica's node — subject to a
latency constraint from an analytic M/M/c queueing model over the
replica's chip capacity.  One epoch of routing is ONE call to
:func:`route_epoch`: ``xp = numpy`` in the host loop (the reference's
1-D code, lanes are the active jobs), ``xp = torch`` in the scanned driver
and the ensemble, where :func:`route_epoch_batched` routes every lane of an
(L, S) slot table at once (the scan is its L = 1 case).  Routing decisions
are **bit-exact** across the drivers and devices:

- **Integer demand.**  Request counts are int32 (``traffic.REQ_CAP``
  bounds every product); splits, prefix sums and spills are int32
  arithmetic with the dtype pinned on every torch reduction (torch's
  ``sum``/``cumsum`` of int32 return int64 unless told otherwise; numpy's
  return int64 too: the values agree while nothing overflows, and the
  bounds below say why nothing does).  Integer scatter-adds are exact in
  any order, atomics included.  The only floats in the *decision* are the
  f32 sort key ``pue·ci`` (one correctly rounded multiply of the same f32
  inputs) and the f32 greenness blend ``floor(γ·R)`` (one multiply, one
  floor; eager torch rounds after every op, so ``rounding_pin`` is an
  identity).
- **Host-built capacity table.**  The M/M/c inversion (the largest
  arrival rate whose modeled p99 meets the SLO) divides and bisects, so
  it runs ONCE per run on the host (:func:`lambda_caps`, f64 numpy) and
  every driver gathers from the same int32 table — per lane in the
  ensemble, so a (SLO x greenness) grid is one bucket.  Each entry is
  bisected on its own, so tables built to different ``c_max`` agree on
  their common prefix.
- **Rational queueing model.**  Erlang C comes from the Erlang-B
  recurrence (add/mul/div only) and the p99 tail uses the exponential-
  wait approximation ``p99 = 1/mu + ln(100)·Wq`` with ``ln(100)`` a host
  constant.  :func:`modeled_p99` is a *metric* (f64 host vs f32 device,
  held to rtol 1e-3), never a decision input.

Water-fill semantics per service: a ``(1-γ)·R`` share is split equally
across replicas first — the carbon-blind load-balancing baseline — then
the ``floor(γ·R)`` green share fills lanes in carbon order (replicas sort
by carbon rate, then job id) up to each lane's RESIDUAL p99-feasible
capacity (infeasible lanes — service time alone above the SLO — have
capacity 0 and are skipped), so the blend itself never pushes a lane over
its admissible rate.  Overload beyond total feasible capacity spills onto
the lowest-carbon *feasible* replica (or the lowest-carbon replica
outright when none is feasible) and is counted as a p99 violation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.placement import rounding_pin
from repro_torch.core.traffic import REQ_CAP

__all__ = ["LN100", "LN2", "erlang_c", "mmc_p99", "mmc_p50",
           "lambda_caps", "modeled_p99", "route_epoch",
           "route_epoch_batched"]

#: Tail constants, precomputed on the host so the device code stays
#: rational.
LN100 = float(np.log(100.0))
LN2 = float(np.log(2.0))

#: Modeled p99 reported for unstable lanes (offered >= capacity).
_P99_UNSTABLE_S = 1.0e6


# ---------------------------------------------------------------------------
# analytic M/M/c model (host f64; xp-generic metric variant)
# ---------------------------------------------------------------------------


def erlang_c(c, a):
    """Erlang-C delay probability C(c, a) via the Erlang-B recurrence —
    rational ops only.  ``c`` int array-like (servers), ``a`` offered
    load in Erlangs (lam/mu); requires ``a < c`` for a meaningful queue.
    Vectorized host/f64 reference (the device twin lives in
    :func:`modeled_p99` with a static unroll bound)."""
    c = np.asarray(c, np.int64)
    a = np.asarray(a, np.float64)
    b = np.ones(np.broadcast(c, a).shape, np.float64)
    for k in range(1, int(c.max(initial=0)) + 1):
        b = np.where(k <= c, (a * b) / (k + a * b), b)
    denom = np.maximum(c - a * (1.0 - b), 1e-300)
    return np.where(c > 0, c * b / denom, 1.0)


def _mmc_percentile(c, mu, lam, ln_q):
    """Sojourn percentile: service time + exponential-wait tail
    ``ln_q · Wq`` with ``Wq = C/(c·mu - lam)``.  Unstable (lam >= c·mu)
    -> :data:`_P99_UNSTABLE_S`."""
    c = np.asarray(c, np.int64)
    lam = np.asarray(lam, np.float64)
    denom = c * float(mu) - lam
    stable = (denom > 0.0) & (c > 0)
    wq = erlang_c(c, lam / float(mu)) / np.maximum(denom, 1e-300)
    return np.where(stable, 1.0 / float(mu) + ln_q * wq, _P99_UNSTABLE_S)


def mmc_p99(c, mu, lam):
    """Modeled p99 sojourn time (s) of an M/M/c replica: ``c`` chips each
    serving ``mu`` req/s, offered ``lam`` req/s.  Monotone increasing in
    ``lam`` and decreasing in ``c``."""
    return _mmc_percentile(c, mu, lam, LN100)


def mmc_p50(c, mu, lam):
    """Modeled p50 sojourn time (s) — same tail approximation at ln 2."""
    return _mmc_percentile(c, mu, lam, LN2)


def lambda_caps(c_max: int, mu: float, slo_s: float, *,
                epoch_s: float = 3600.0, iters: int = 60) -> np.ndarray:
    """Per-chip-count feasible capacity table: entry ``c`` is the largest
    int32 requests/epoch a ``c``-chip replica can serve with modeled p99
    <= ``slo_s`` (0 when even the bare service time breaks the SLO —
    the *infeasible replica* mask).  Fixed-iteration f64 bisection on
    ``lam in [0, c·mu)``, each entry on its own; computed once per run on
    the HOST and consumed by every driver as data.  Capped at
    ``traffic.REQ_CAP``."""
    cs = np.arange(int(c_max) + 1, dtype=np.int64)
    mu, slo_s = float(mu), float(slo_s)
    lo = np.zeros(cs.shape, np.float64)
    hi = np.maximum(cs * mu, 0.0)
    for _ in range(int(iters)):
        mid = 0.5 * (lo + hi)
        ok = mmc_p99(cs, mu, mid) <= slo_s
        lo = np.where(ok, mid, lo)
        hi = np.where(ok, hi, mid)
    feasible = (cs > 0) & (1.0 / mu <= slo_s)
    cap = np.floor(lo * epoch_s)
    return np.where(feasible, np.minimum(cap, REQ_CAP), 0).astype(np.int32)


def modeled_p99(xp, routed, chips, c_max: int, mu, *,
                epoch_s: float = 3600.0):
    """Per-lane modeled p99 sojourn (s) at the routed per-epoch load —
    the elementwise twin of :func:`mmc_p99` with the Erlang-B recurrence
    unrolled to the static ``c_max``: f64 with ``xp = numpy``, f32 with
    ``xp = torch`` (any shape; ``mu`` a float or a tensor that broadcasts,
    e.g. one value per lane).  A reported *metric*, not a routing input."""
    if xp is np:
        ft = np.float64
        c = np.asarray(chips).astype(ft)
        lam = np.asarray(routed).astype(ft) / ft(epoch_s)
    else:
        c = chips.to(torch.float32)
        lam = routed.to(torch.float32) / epoch_s
    a = lam / mu
    b = xp.ones_like(lam)
    for k in range(1, int(c_max) + 1):
        ab = a * b
        b = xp.where(k <= c, ab / (k + ab), b)
    denom2 = c - a * (1.0 - b)
    denom2 = np.maximum(denom2, 1e-30) if xp is np \
        else denom2.clamp(min=1e-30)
    ec = c * b / denom2
    denom = c * mu - lam
    stable = (denom > 0.0) & (c > 0)
    denom = np.maximum(denom, 1e-30) if xp is np else denom.clamp(min=1e-30)
    wq = ec / denom
    return xp.where(stable, 1.0 / mu + LN100 * wq, _P99_UNSTABLE_S)


# ---------------------------------------------------------------------------
# the per-epoch router
# ---------------------------------------------------------------------------


def _route_np(*, req_t, svc, jid, weight, cap, carbon, n_svc: int,
              greenness):
    """The reference's numpy ``route_epoch`` over 1-D lanes, op for op."""
    i32, f32 = np.int32, np.float32
    greenness = np.asarray(greenness).astype(f32)
    L = svc.shape[0]
    act = svc >= 0
    skey = np.where(act, svc, n_svc).astype(i32)
    carbon_k = np.where(act, carbon, 0.0).astype(f32)
    jid_k = np.asarray(jid).astype(i32)
    w = np.where(act, weight, 0).astype(i32)
    capi = np.where(act, cap, 0).astype(i32)

    def seg_sum(idx, vals):
        out = np.zeros(n_svc + 1, i32)
        np.add.at(out, idx, vals.astype(i32))
        return out

    # ---- offered load per service: integer weight shares --------------
    seg_w = seg_sum(skey, w)
    w_tot = seg_w[:n_svc].sum()
    req_t = np.asarray(req_t).astype(i32)
    offered = np.where(w_tot > 0, (req_t * seg_w) // np.maximum(w_tot, 1), 0)
    offered = np.where(np.arange(n_svc + 1) < n_svc, offered, 0)
    # floor remainder goes to the first service carrying weight
    first_s = np.argmax(seg_w[:n_svc] > 0)
    rem_t = req_t - offered[:n_svc].sum()
    offered = offered + np.where(
        (np.arange(n_svc + 1) == first_s) & (w_tot > 0), rem_t, 0)

    # ---- sort lanes by (service, marginal carbon, jid) ----------------
    perm = np.lexsort((jid_k, carbon_k, skey))
    s_s = skey[perm]
    cap_s = capi[perm]
    act_s = s_s < n_svc
    one_s = act_s.astype(i32)
    feas_s = (act_s & (cap_s > 0)).astype(i32)

    def seg_prefix(vals):
        cs = np.cumsum(vals)
        totals = seg_sum(s_s, vals)
        base = np.cumsum(totals) - totals
        return cs - base[s_s], totals

    arank, seg_cnt = seg_prefix(one_s)        # 1-based active rank
    frank, seg_feas = seg_prefix(feas_s)      # 1-based feasible rank

    # ---- greenness blend ------------------------------------------------
    r_seg = offered
    r_green = np.floor(rounding_pin(greenness * r_seg.astype(f32))
                       ).astype(i32)
    r_green = np.clip(r_green, 0, r_seg)
    r_even = r_seg - r_green
    q = r_even // np.maximum(seg_cnt, 1)
    rem = r_even - q * seg_cnt
    even = np.where(act_s, q[s_s] + (arank <= rem[s_s]).astype(i32), 0)
    cap_res = np.maximum(np.where(act_s, cap_s, 0) - even, 0)
    prefix_res, _ = seg_prefix(cap_res)
    prefix_res = prefix_res - cap_res          # exclusive
    green = np.clip(r_green[s_s] - prefix_res, 0, cap_res)
    g_fill = seg_sum(s_s, green)
    leftover = r_green - g_fill
    spill_tgt = np.where(seg_feas[s_s] > 0,
                         (feas_s > 0) & (frank == 1),
                         act_s & (arank == 1))
    green = green + np.where(spill_tgt, leftover[s_s], 0)

    routed_s = np.where(act_s, green + even, 0)
    routed = np.zeros(L, i32)
    routed[perm] = routed_s
    return routed, offered


def route_epoch_batched(*, req_t, svc, jid, weight, cap, carbon,
                        n_svc: int, greenness):
    """:func:`route_epoch` for L lanes at once, on any device.

    Every input carries a leading lane axis: ``req_t`` (L,), ``svc``,
    ``jid``, ``weight``, ``cap`` and ``carbon`` (L, S), ``greenness``
    (L,).  Each lane is routed on its own with its own request count,
    greenness and capacities, by the numpy path's arithmetic: per-lane
    segment sums over the ``n_svc + 1`` service bins (the last is the
    inactive sentinel), cumsums along the lane's row (the lanes are
    sorted by service, so a service's slots are contiguous) and one
    stable sort per key, minor key first.  Returns ``(routed (L, S),
    offered (L, n_svc + 1))``, int32."""
    i32, f32 = torch.int32, torch.float32
    dev = svc.device
    L, S = svc.shape
    B = n_svc + 1
    bins = torch.arange(B, device=dev)
    greenness = torch.as_tensor(greenness, device=dev).to(f32)
    act = svc >= 0
    skey = torch.where(act, svc, n_svc).to(i32)
    carbon_k = torch.where(act, carbon, 0.0).to(f32)
    jid_k = jid.to(i32)
    w = torch.where(act, weight, 0).to(i32)
    capi = torch.where(act, cap, 0).to(i32)

    def seg_sum(idx, vals):
        """(L, B) int32 per-lane bin sums (integer adds: exact in any
        order)."""
        return torch.zeros((L, B), dtype=i32, device=dev).scatter_add_(
            1, idx, vals.to(i32))

    # ---- offered load per service: integer weight shares --------------
    seg_w = seg_sum(skey.long(), w)
    w_tot = seg_w[:, :n_svc].sum(1, keepdim=True, dtype=i32)
    req_t = torch.as_tensor(req_t, device=dev).to(i32)[:, None]
    # req_t <= REQ_CAP and seg_w <= WEIGHT_SUM_CAP (validate_qps_weights),
    # so the product stays below 2^31
    offered = torch.where(w_tot > 0,
                          (req_t * seg_w) // w_tot.clamp(min=1), 0)
    offered = torch.where(bins < n_svc, offered, 0)
    # floor remainder goes to the first service carrying weight (argmax
    # returns the first of tied maxima; it takes no bool, hence the cast)
    first_s = torch.argmax((seg_w[:, :n_svc] > 0).to(i32), dim=1,
                           keepdim=True)
    rem_t = req_t - offered[:, :n_svc].sum(1, keepdim=True, dtype=i32)
    offered = offered + torch.where((bins == first_s) & (w_tot > 0),
                                    rem_t, 0)

    # ---- sort lanes by (service, marginal carbon, jid) ----------------
    # np.lexsort as three stable sorts, minor key first; never topk.  The
    # keys hold no -0.0 (pue > 0, ci >= 0, inactive lanes 0.0), which a
    # device radix sort would order below +0.0.  Empty slots all carry
    # jid -1: the stable sorts still give a permutation to scatter back
    perm = torch.sort(jid_k, dim=1, stable=True).indices
    perm = perm.gather(1, torch.sort(carbon_k.gather(1, perm), dim=1,
                                     stable=True).indices)
    perm = perm.gather(1, torch.sort(skey.gather(1, perm), dim=1,
                                     stable=True).indices)
    s_s = skey.gather(1, perm)
    s_i = s_s.long()
    cap_s = capi.gather(1, perm)
    act_s = s_s < n_svc
    one_s = act_s.to(i32)
    feas_s = (act_s & (cap_s > 0)).to(i32)

    def seg_prefix(vals):
        """Within-service inclusive prefix along each lane's sorted row,
        and the per-service totals.  The largest prefix is a row's sum of
        capacities, S·REQ_CAP: int32 for S < 32768 slots."""
        cs = vals.cumsum(1, dtype=i32)
        totals = seg_sum(s_i, vals)
        base = totals.cumsum(1, dtype=i32) - totals
        return cs - base.gather(1, s_i), totals

    arank, seg_cnt = seg_prefix(one_s)        # 1-based active rank
    frank, seg_feas = seg_prefix(feas_s)      # 1-based feasible rank

    # ---- greenness blend ------------------------------------------------
    r_seg = offered
    r_green = torch.floor(rounding_pin(greenness[:, None]
                                       * r_seg.to(f32))).to(i32)
    r_green = torch.minimum(r_green.clamp(min=0), r_seg)
    r_even = r_seg - r_green
    q = r_even // seg_cnt.clamp(min=1)
    rem = r_even - q * seg_cnt
    even = torch.where(act_s, q.gather(1, s_i)
                       + (arank <= rem.gather(1, s_i)).to(i32), 0)
    cap_res = (torch.where(act_s, cap_s, 0) - even).clamp(min=0)
    prefix_res, _ = seg_prefix(cap_res)
    prefix_res = prefix_res - cap_res          # exclusive
    green = torch.minimum((r_green.gather(1, s_i) - prefix_res).clamp(min=0),
                          cap_res)
    g_fill = seg_sum(s_i, green)
    leftover = r_green - g_fill
    spill_tgt = torch.where(seg_feas.gather(1, s_i) > 0,
                            (feas_s > 0) & (frank == 1),
                            act_s & (arank == 1))
    green = green + torch.where(spill_tgt, leftover.gather(1, s_i), 0)

    routed_s = torch.where(act_s, green + even, 0)
    routed = torch.zeros((L, S), dtype=i32, device=dev).scatter_(
        1, perm, routed_s)
    return routed, offered


def route_epoch(xp, *, req_t, svc, jid, weight, cap, carbon, n_svc: int,
                greenness):
    """Split one epoch's fleet request load across serving replicas.

    Lanes are job slots: ``svc`` (i32, -1 = not a serving replica or not
    active), ``jid`` (i32 job id, unique among real lanes), ``weight``
    (i32 QPS share weight), ``cap`` (i32 p99-feasible requests/epoch from
    :func:`lambda_caps`), ``carbon`` (f32 marginal-carbon sort key
    ``pue·ci`` of the replica's node).  ``req_t`` is the epoch's fleet
    request count (i32 scalar), ``greenness`` the f32 carbon-greediness
    ``γ``, ``n_svc`` the service count.  ``xp = numpy`` runs the
    reference's host code; ``xp = torch`` runs :func:`route_epoch_batched`
    as one lane.

    Returns ``(routed, offered)``: per-lane int32 requests routed and the
    per-service int32 offered load (bin ``n_svc`` is the inactive
    sentinel, always 0).  Conservation: ``routed`` sums to ``offered``
    within every service that has at least one active replica; ``offered``
    sums to ``req_t`` whenever any replica is active."""
    if xp is np:
        return _route_np(req_t=req_t, svc=svc, jid=jid, weight=weight,
                         cap=cap, carbon=carbon, n_svc=n_svc,
                         greenness=greenness)
    dev = svc.device
    routed, offered = route_epoch_batched(
        req_t=torch.as_tensor(req_t, device=dev).reshape(1),
        svc=svc[None], jid=jid[None], weight=weight[None], cap=cap[None],
        carbon=carbon[None], n_svc=n_svc,
        greenness=torch.as_tensor(greenness, device=dev).reshape(1))
    return routed[0], offered[0]
