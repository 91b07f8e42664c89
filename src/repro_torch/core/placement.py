"""Fused top-k shortlist placement: O(N + J·K) instead of O(J·N).

Torch twin of ``repro.core.placement``: the sequential engines and the
hand-batched ensemble engine ``place_lifecycle_batched``.  The design and
the exactness argument are the reference's:

1. **Frozen normalizers.**  The Eq. 1 min-max lo/hi are computed once per
   placement call, so a node's score depends only on its own free
   capacity and landing a job changes exactly one score.
2. **Shortlist + exactness bound.**  One O(N) sweep yields the K-node
   shortlist plus the (K+1)-th best (score, index) pair, the bound.  While
   the shortlist's best feasible entry beats the bound it is the global
   argmin.
3. **Fallback sweeps** when the bound is violated or the epoch is dirty (a
   release landed outside the shortlist).

``place_lifecycle_full_rerank`` is the O(J·N) oracle.  Placements are
bit-identical: every tie breaks toward the lower node index (stable sort,
``torch.argmin``'s first occurrence, the in-shortlist lexicographic pick),
and the per-evaluation score math is division-free elementwise mul/add in
the reference's op order.  Torch eager rounds after every op, so the
reference's ``optimization_barrier`` pins are identities here and the O(1)
rescore of one node (``_one_score``, the same function on a length-1
slice) is bitwise the O(N) sweep's value.

The event loop is a host Python loop.  The shortlist state (K scores and
node ids, the bound, ``cap_max``, the dirty flag) and a mirror of the free
capacity live on the host; the device holds the capacity the sweeps read
and the frozen context.  Each arrival placed from the shortlist rescores
its node on the device and reads the one score back (one sync per event);
each sweep reads back its masked argmin and the K+1 candidates.

``place_lifecycle_batched`` runs the arrival-only event streams of L
ensemble lanes together: an inner walk over events with O(L·K) shortlist
work per step, and one batched O(L·N) sweep per round for the lanes that
stalled.  Its loop tests read one flag back from the device each
(``HostSyncs`` counts them).  With a ``NodeSplit`` it runs on this
rank's slice of the node axis (the reference's ``("e", "n")`` mesh,
``simulate_fleet_ensemble(shard="en")``): the sweep (K4 with
``use_kernel``) scores the rank's nodes only, and every reduction over
nodes is a collective of the n-axis group with the reference's tie rule
(see ``NodeSplit``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.energy import DEFAULT_ENERGY, EnergyModel
from repro_torch.core.fleet import FIELDS, IDLE_POWER_FRAC, Fleet
from repro_torch.core.ranking import RankWeights


def rounding_pin(x):
    """The reference's f32 rounding pin (``optimization_barrier``): an
    identity in eager torch, which rounds after every op."""
    return x


@dataclasses.dataclass
class PlacementResult:
    node: torch.Tensor      # (J,) int32 chosen node per event; -1 = none
    scores: torch.Tensor    # (N,) scores at FINAL occupancy (frozen lo/hi)
    capacity: torch.Tensor  # (N,) int32 free chips after all events
    n_sweeps: int           # full O(N) decision sweeps performed


def _minmax(t: torch.Tensor):
    return t.min(), t.max()


def _lo_rcp(t: torch.Tensor, minmax=_minmax):
    """(lo, 1/span, hi); a degenerate span (<= 1e-12) gives rcp 0 so an
    information-free term contributes exactly 0.  ``minmax`` takes the
    node axis's min and max (over every rank's nodes under a split)."""
    lo, hi = minmax(t)
    span = hi - lo
    rcp = torch.where(span > 1e-12,
                      torch.reciprocal(torch.clamp_min(span, 1e-12)), 0.0)
    return lo, rcp, hi


def frozen_ctx(fleet: Fleet, weights: RankWeights = RankWeights(),
               horizon_h: float = 1.0,
               energy: Optional[EnergyModel] = None, minmax=_minmax
               ) -> Dict[str, torch.Tensor]:
    """One-time per-placement context: the cap-independent Eq. 1 pieces,
    op for op ``repro.core.placement.frozen_ctx``.  All divisions happen
    here; ``lohi`` is the (4, 2) (or (5, 2)) matrix the rank kernel
    consumes for the same normalization.  ``minmax`` as in ``_lo_rcp``:
    on a node slice the per-node pieces are the slice's, and every
    normalizer is the whole fleet's."""
    pk = fleet.power_kw * horizon_h
    a_now = pk * fleet.pue * fleet.ci_now
    a_fc = pk * fleet.pue * fleet.ci_forecast
    inv_total = torch.reciprocal(
        torch.clamp_min(fleet.chips_total.to(torch.float32), 1.0))
    eff = fleet.flops_per_j
    sched = fleet.sched_term

    def mm(x):
        lo, rcp, _ = _lo_rcp(x, minmax)
        return (x - lo) * rcp

    static = (weights.w3 * (1.0 - mm(eff)) + weights.w4 * mm(sched))

    em = energy
    if em is None and weights.marginal:
        em = DEFAULT_ENERGY.device(w_marginal=weights.marginal,
                                   device=fleet.device)
    idle_f = IDLE_POWER_FRAC if em is None else em.idle_frac
    dyn_f = (1.0 - IDLE_POWER_FRAC) if em is None else em.dyn_frac

    cap0 = fleet.capacity.to(torch.float32)
    factor0 = idle_f + dyn_f * (1.0 - cap0 * inv_total)
    cfp0, fcfp0 = a_now * factor0, a_fc * factor0
    lo_now, rcp_now, hi_now = _lo_rcp(cfp0, minmax)
    lo_fc, rcp_fc, hi_fc = _lo_rcp(fcfp0, minmax)
    lohi = torch.stack([
        torch.stack([lo_now, hi_now]), torch.stack([lo_fc, hi_fc]),
        torch.stack(minmax(eff)), torch.stack(minmax(sched))])
    ctx = dict(a_now=a_now, a_fc=a_fc, inv_total=inv_total, static=static,
               idle_f=idle_f, dyn_f=dyn_f,
               lo_now=lo_now, rcp_now=rcp_now, lo_fc=lo_fc, rcp_fc=rcp_fc,
               lohi=lohi)
    if em is not None:
        # marginal-CFP context: per-chip dynamic carbon for on nodes, the
        # two-part wake price for powered-off ones; normalizer frozen at
        # entry.  With w_m == 0 the term adds exactly +0.0.
        ct_f = fleet.chips_total.to(torch.float32)
        emb_h = em.embodied_g_per_node_h * horizon_h
        m_dyn = a_now * inv_total * dyn_f
        m_wake = a_now * idle_f + emb_h
        mcfp0 = m_dyn + torch.where(cap0 == ct_f, m_wake, 0.0)
        lo_m, rcp_m, hi_m = _lo_rcp(mcfp0, minmax)
        ctx.update(m_dyn=m_dyn, m_wake=m_wake, ct_f=ct_f,
                   emb_h=torch.as_tensor(emb_h, dtype=torch.float32,
                                         device=fleet.device),
                   lo_m=lo_m, rcp_m=rcp_m,
                   lohi=torch.cat([lohi, torch.stack([lo_m, hi_m])[None]]),
                   w_m=torch.as_tensor(em.w_marginal, dtype=torch.float32,
                                       device=fleet.device))
    return ctx


_GATHERED = ("a_now", "a_fc", "inv_total", "static",
             "m_dyn", "m_wake", "ct_f")


def _ctx_scores(cap, ctx, w: RankWeights) -> torch.Tensor:
    """Eq. 1 with frozen normalizers, elementwise over ``cap`` (a tensor,
    or one node's free chips as a python int — exact in f32)."""
    capf = cap.to(torch.float32) if isinstance(cap, torch.Tensor) \
        else float(cap)
    occ = 1.0 - capf * ctx["inv_total"]
    dyn = ctx["dyn_f"] * occ
    factor = ctx["idle_f"] + dyn
    cfp = ctx["a_now"] * factor
    fcfp = ctx["a_fc"] * factor
    t1 = w.w1 * ((cfp - ctx["lo_now"]) * ctx["rcp_now"])
    t2 = w.w2 * ((fcfp - ctx["lo_fc"]) * ctx["rcp_fc"])
    score = (t1 + t2) + ctx["static"]
    if "m_dyn" in ctx:
        # select-then-add: score >= +0.0, so adding the w_m == 0 term is
        # bitwise the 4-term score
        mcfp = ctx["m_dyn"] + torch.where(capf == ctx["ct_f"],
                                          ctx["m_wake"], 0.0)
        score = score + ctx["w_m"] * ((mcfp - ctx["lo_m"]) * ctx["rcp_m"])
    return score


def _one_score(cap_b: int, b: int, ctx, w: RankWeights) -> float:
    """Rescore node ``b`` at free chips ``cap_b`` in O(1): the sweep's
    function on a length-1 slice, so bitwise ``_ctx_scores(cap)[b]``.
    Returns the f32 value as a python float (one sync)."""
    g = {k: (v[b:b + 1] if k in _GATHERED else v) for k, v in ctx.items()}
    return _ctx_scores(int(cap_b), g, w)[0].item()


def _host_ints(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def _masked_argmin(masked: torch.Tensor) -> Tuple[int, bool]:
    """(first index of the minimum, whether it is finite) with one sync."""
    best = torch.argmin(masked)
    pair = torch.stack([best.to(torch.float64),
                        masked[best].to(torch.float64)]).tolist()
    return int(pair[0]), math.isfinite(pair[1])


def _result(fleet, out, cap, ctx, weights, sweeps) -> PlacementResult:
    return PlacementResult(
        node=torch.as_tensor(out, dtype=torch.int32, device=fleet.device),
        scores=_ctx_scores(cap, ctx, weights), capacity=cap,
        n_sweeps=sweeps)


def place_jobs_full_rerank(fleet: Fleet, demands,
                           weights: RankWeights = RankWeights(),
                           horizon_h: float = 1.0,
                           energy: Optional[EnergyModel] = None
                           ) -> PlacementResult:
    """O(J·N) oracle: full fleet rescore + masked argmin per job."""
    dem = _host_ints(demands)
    return place_lifecycle_full_rerank(
        fleet, dem, np.full(dem.shape[0], -1), weights, horizon_h,
        energy=energy)


def place_lifecycle_full_rerank(fleet: Fleet, demands, nodes,
                                weights: RankWeights = RankWeights(),
                                horizon_h: float = 1.0, *,
                                capacity: Optional[torch.Tensor] = None,
                                n_events: Optional[int] = None,
                                energy: Optional[EnergyModel] = None
                                ) -> PlacementResult:
    """Lifecycle oracle over an event stream, O(arrivals · N).

    ``demands[e] > 0``: arrival — full rescore, masked argmin, land the job.
    ``demands[e] < 0``: release of ``-demands[e]`` chips on ``nodes[e]``.
    ``demands[e] == 0``: no-op (padding).  ``capacity`` starts the loop at
    a post-release snapshot while the normalizers stay frozen at
    ``fleet.capacity``; ``n_events`` truncates the loop."""
    dem, tgt = _host_ints(demands), _host_ints(nodes)
    ctx = frozen_ctx(fleet, weights, horizon_h, energy=energy)
    cap = (fleet.capacity if capacity is None else capacity).to(
        torch.int32).clone()
    healthy = fleet.healthy
    out = np.full(dem.shape[0], -1, np.int64)
    sweeps = 0
    for e in range(dem.shape[0] if n_events is None else int(n_events)):
        d = int(dem[e])
        if d > 0:
            scores = _ctx_scores(cap, ctx, weights)
            chosen, ok = _masked_argmin(
                torch.where((cap >= d) & healthy, scores, torch.inf))
            sweeps += 1
        elif d < 0:
            chosen, ok = int(tgt[e]), True
        else:
            continue
        if ok:
            cap[chosen] -= d
            out[e] = chosen
    return _result(fleet, out, cap, ctx, weights, sweeps)


def place_jobs_shortlist(fleet: Fleet, demands,
                         weights: RankWeights = RankWeights(),
                         horizon_h: float = 1.0, *,
                         shortlist: int = 32,
                         use_kernel: bool = False,
                         energy: Optional[EnergyModel] = None
                         ) -> PlacementResult:
    """Arrivals-only wrapper over the lifecycle engine."""
    dem = _host_ints(demands)
    return place_lifecycle_shortlist(
        fleet, dem, np.full(dem.shape[0], -1), weights, horizon_h,
        shortlist=shortlist, use_kernel=use_kernel, energy=energy)


def _sweep_fn(fleet: Fleet, ctx, weights: RankWeights, horizon_h: float,
              energy: Optional[EnergyModel], use_kernel: bool, k_cand: int):
    """One epoch sweep: cap -> (scores (N,), top (K+1) scores, their node
    ids) in (score, node index) order."""
    if not use_kernel:
        from repro_torch.kernels.ops import lex_head

        def sweep(cap):
            scores = _ctx_scores(cap, ctx, weights)
            top_s, idx = lex_head(scores, k_cand)
            return scores, top_s, idx.to(torch.int32)
        return sweep

    from repro_torch.kernels.ops import maiz_ranking_topk

    # custom idle/dynamic watts reach the kernel through the ``ec`` stream;
    # the marginal-CFP term (when frozen_ctx materialized it) through the
    # pk/cap/ct node streams + the (4,) en scalar block
    em_k = energy
    if em_k is None and weights.marginal:
        em_k = DEFAULT_ENERGY.device(w_marginal=weights.marginal,
                                     device=fleet.device)
    mkw = {}
    if em_k is not None:
        mkw = dict(pk=fleet.power_kw * horizon_h, chips_total=ctx["ct_f"],
                   en=torch.stack([torch.as_tensor(ctx[k], dtype=torch.float32,
                                                   device=fleet.device)
                                   for k in ("idle_f", "dyn_f", "emb_h",
                                             "w_m")]))
    sched = fleet.sched_term
    w_arr = weights.as_array(fleet.device)

    def sweep(cap):
        ec = fleet.effective_power_kw(cap, energy=em_k) * horizon_h
        kw = dict(mkw, cap=cap.to(torch.float32)) if mkw else {}
        return maiz_ranking_topk(
            ec, fleet.pue, fleet.ci_now, fleet.ci_forecast,
            fleet.flops_per_j, sched, w_arr, k=k_cand, lohi=ctx["lohi"],
            **kw)
    return sweep


def place_lifecycle_shortlist(fleet: Fleet, demands, nodes,
                              weights: RankWeights = RankWeights(),
                              horizon_h: float = 1.0, *,
                              shortlist: int = 32,
                              use_kernel: bool = False,
                              capacity: Optional[torch.Tensor] = None,
                              n_events: Optional[int] = None,
                              eager_sweep: bool = False,
                              energy: Optional[EnergyModel] = None
                              ) -> PlacementResult:
    """Shortlist-greedy lifecycle placement, bit-identical to the oracle.

    Event semantics match ``place_lifecycle_full_rerank``.  ``shortlist``
    is K; ``use_kernel`` routes the epoch sweeps through the rank kernel
    (``repro_torch.kernels.ops.maiz_ranking_topk``: the CUDA kernel on the
    card, its plain twin on the CPU).  The engine starts dirty: leading
    releases are O(1) capacity edits and the first arrival sweeps.
    Releases on shortlist nodes are rescored in O(1); releases outside the
    shortlist make the epoch dirty.  ``eager_sweep`` computes the epoch's
    first sweep up front (valid for release-free streams only; placements
    and sweep counts are unchanged)."""
    dem, tgt = _host_ints(demands), _host_ints(nodes)
    N, E = fleet.n, dem.shape[0]
    K = min(max(shortlist, 1), N)
    full_cover = K >= N          # shortlist == whole fleet: bound unused
    ctx = frozen_ctx(fleet, weights, horizon_h, energy=energy)
    cap = (fleet.capacity if capacity is None else capacity).to(
        torch.int32).clone()
    cap_h = cap.cpu().numpy().astype(np.int64)      # host mirror of cap
    healthy = fleet.healthy
    healthy_h = healthy.cpu().numpy()
    inf32 = np.float32(np.inf)
    sweep_topk = _sweep_fn(fleet, ctx, weights, horizon_h, energy,
                           use_kernel, min(K + 1, N))
    eager = sweep_topk(cap) if eager_sweep else None

    out = np.full(E, -1, np.int64)
    sl_s = np.full(K, inf32, np.float32)
    sl_i = np.full(K, N, np.int64)
    bound_s, bound_i = inf32, N
    cap_max = int(np.max(np.where(healthy_h, cap_h, 0)))
    sweeps, dirty = 0, True

    for e in range(E if n_events is None else int(n_events)):
        d = int(dem[e])
        if d == 0:
            continue
        if d < 0:
            # release: credit -d chips to node b, O(1), never sweeps
            b = int(tgt[e])
            new_cap = int(cap_h[b]) - d
            hitmask = sl_i == b
            hit = (not dirty) and bool(hitmask.any())
            if hit:
                sl_s = np.where(hitmask,
                                np.float32(_one_score(new_cap, b, ctx,
                                                      weights)), sl_s)
            cap_max = max(cap_max, new_cap if healthy_h[b] else 0)
            dirty = dirty or not hit
            chosen, ok = b, True
        else:
            use_sl = feasible = False
            if not dirty:
                # best feasible (capacity + health) shortlist entry by
                # (score, node index)
                sm = np.where((cap_h[sl_i] >= d) & healthy_h[sl_i], sl_s,
                              inf32)
                m = sm.min()
                kbest = int(np.argmin(np.where(sm == m, sl_i, N)))
                bnode = int(sl_i[kbest])
                feasible = bool(np.isfinite(m))
                beats = (m < bound_s) or (m == bound_s and bnode < bound_i)
                use_sl = feasible and beats
            dead = d > cap_max or ((not dirty) and (not feasible)
                                   and not np.isfinite(bound_s))
            if use_sl:
                sl_s[kbest] = _one_score(int(cap_h[bnode]) - d, bnode, ctx,
                                         weights)
                chosen, ok = bnode, True
            elif dead:
                ok = False
            else:
                # fresh O(N) sweep: exact placement from the full masked
                # argmin, and a new clean epoch
                swept = eager if (eager is not None and sweeps == 0) \
                    else sweep_topk(cap)
                scores, cand_s, cand_i = swept
                chosen, ok = _masked_argmin(
                    torch.where((cap >= d) & healthy, scores, torch.inf))
                cand_s = cand_s.cpu().numpy().astype(np.float32)
                cand_i = cand_i.cpu().numpy().astype(np.int64)
                sl_s, sl_i = cand_s[:K].copy(), cand_i[:K].copy()
                bound_s, bound_i = (inf32, N) if full_cover \
                    else (cand_s[K], int(cand_i[K]))
                if ok:
                    sl_s = np.where(sl_i == chosen, np.float32(_one_score(
                        int(cap_h[chosen]) - d, chosen, ctx, weights)),
                        sl_s)
                cap_max = int(np.max(np.where(healthy_h, cap_h, 0)))
                sweeps += 1
                dirty = False
        if ok:
            cap_h[chosen] -= d
            cap[chosen] -= d
            out[e] = chosen
    return _result(fleet, out, cap, ctx, weights, sweeps)


# ---------------------------------------------------------------------------
# hand-batched lifecycle engine: an explicit lane axis for the ensemble
# ---------------------------------------------------------------------------


class HostSyncs:
    """Counts the device-to-host reads a driver makes: each loop test of
    the batched engine reads one flag back and waits for the device."""

    def __init__(self) -> None:
        self.n = 0

    def any(self, x: torch.Tensor) -> bool:
        self.n += 1
        return bool(x.any())


class WholeAxis:
    """The node axis on one rank: every reduction and gather is local
    (the engine's own ops; ``NodeSplit`` is the split form)."""
    off = 0
    minmax = staticmethod(_minmax)

    def n_total(self, n_local: int) -> int:
        """The whole axis' node count from this rank's."""
        return n_local

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def local_ids(self, idx: torch.Tensor) -> torch.Tensor:
        """Node ids (L, k) as this rank's positions, any id it does not
        hold (the drop sentinel N included) as its own sentinel."""
        return idx

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def amax(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(1)

    def amin(self, x: torch.Tensor) -> torch.Tensor:
        return x.amin(1)

    def min_all(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise min of ``x`` over the ranks of the split."""
        return x

    def argmin(self, masked: torch.Tensor):
        """(per lane the first index of the min, the min)."""
        best = torch.argmin(masked, dim=1)
        return best, masked.gather(1, best[:, None])[:, 0]

    def take(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """x (L, N) at node ids idx (L, k), every id < N."""
        return x.gather(1, idx)

    def add_at(self, x: torch.Tensor, idx: torch.Tensor,
               val: torch.Tensor) -> None:
        """x[l, idx[l, j]] += val[l, j] in place (ids < N)."""
        x.scatter_add_(1, idx, val)

    def rescore(self, cap_b, b, ctx, w: RankWeights) -> torch.Tensor:
        return _one_score_b(cap_b, b, ctx, w)

    def merge(self, cand_s, cand_i, k: int):
        return cand_s, cand_i


class NodeSplit(WholeAxis):
    """This rank's contiguous slice [off, off + n) of an N-node axis split
    ``nn`` ways over ``group`` (the ensemble mesh's n-axis ranks, in node
    order), and the reductions over nodes written as its collectives.
    Each keeps the one-rank result bit for bit: min and max all-reduce
    exactly; an argmin gathers each rank's (value, global index) and takes
    the first least value, the lower index on ties as the one-rank argmin
    does; a value at a node id (a gather, the O(1) rescore) is computed by
    the owning rank and copied from it; a scatter into a node buffer is
    applied by the owner only; top-k candidates carry global ids and are
    merged in (score, node index) order.  Every collective is a host
    round trip on gloo."""

    def __init__(self, group, n_nodes: int):
        import torch.distributed as dist
        self.dist, self.group = dist, group
        self.nn = dist.get_world_size(group)
        if n_nodes % self.nn:
            raise ValueError(f"{n_nodes} nodes do not split {self.nn} ways")
        self.n = n_nodes // self.nn
        self.off = dist.get_rank(group) * self.n

    def n_total(self, n_local: int) -> int:
        return self.nn * n_local

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, self.off:self.off + self.n]

    def local_ids(self, idx: torch.Tensor) -> torch.Tensor:
        own, _ = self._owned(idx)
        return torch.where(own, idx - self.off, self.n)

    def _stack(self, x: torch.Tensor) -> torch.Tensor:
        """(nn, *x.shape): every rank's x, in rank order."""
        y = x.to(torch.uint8) if x.dtype == torch.bool else x
        out = y.new_empty((self.nn,) + tuple(y.shape))
        self.dist.all_gather_into_tensor(out, y.contiguous()[None],
                                         group=self.group)
        return out.to(x.dtype)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """(L, N) from every rank's (L, n) slice."""
        st = self._stack(x)
        return st.permute(1, 0, 2).reshape(x.shape[0], -1)

    def minmax(self, t: torch.Tensor):
        both = torch.stack([t.min(), -t.max()])
        self.dist.all_reduce(both, op=self.dist.ReduceOp.MIN,
                             group=self.group)
        return both[0], -both[1]

    def amax(self, x: torch.Tensor) -> torch.Tensor:
        m = x.amax(1)
        self.dist.all_reduce(m, op=self.dist.ReduceOp.MAX, group=self.group)
        return m

    def amin(self, x: torch.Tensor) -> torch.Tensor:
        return self.min_all(x.amin(1))

    def min_all(self, x: torch.Tensor) -> torch.Tensor:
        m = x.contiguous().clone()
        self.dist.all_reduce(m, op=self.dist.ReduceOp.MIN, group=self.group)
        return m

    def argmin(self, masked: torch.Tensor):
        best, val = WholeAxis.argmin(self, masked)
        vals, ids = self._stack(val), self._stack(best + self.off)
        r = torch.argmin(vals, dim=0)[None]
        return ids.gather(0, r)[0], vals.gather(0, r)[0]

    def _owned(self, idx: torch.Tensor):
        own = (idx >= self.off) & (idx < self.off + self.n)
        return own, torch.where(own, idx - self.off, 0)

    def _from_owner(self, v: torch.Tensor, idx: torch.Tensor):
        return self._stack(v).gather(0, (idx // self.n)[None])[0]

    def take(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        _, loc = self._owned(idx)
        return self._from_owner(x.gather(1, loc), idx)

    def add_at(self, x, idx, val) -> None:
        own, loc = self._owned(idx)
        x.scatter_add_(1, loc, torch.where(own, val, 0).to(x.dtype))

    def rescore(self, cap_b, b, ctx, w: RankWeights) -> torch.Tensor:
        # b may be the padding id N where the result is unused
        b = b.clamp(0, self.nn * self.n - 1)
        _, loc = self._owned(b)
        return self._from_owner(_one_score_b(cap_b, loc, ctx, w), b)

    def merge(self, cand_s, cand_i, k: int):
        """The first k of every rank's candidates in (score, node index)
        order: in rank order the candidates' positions follow their node
        ids on equal scores, so ``lex_head``'s (value, position) order is
        the (score, index) order."""
        from repro_torch.kernels.ops import lex_head
        L = cand_s.shape[0]
        s = self._stack(cand_s).permute(1, 0, 2).reshape(L, -1)
        i = self._stack(cand_i + self.off).permute(1, 0, 2).reshape(L, -1)
        top_s, pos = lex_head(s, min(k, s.shape[1]))
        return top_s, i.gather(1, pos)


def _lane(fleet: Fleet, l: int) -> Fleet:
    return Fleet(**{f: getattr(fleet, f)[l] for f in FIELDS})


def stacked_ctx(fleet: Fleet, weights: RankWeights, horizon_h: float,
                energy, minmax=_minmax) -> Dict[str, object]:
    """The (L, ...) frozen context: each lane's sequential ``frozen_ctx``,
    stacked (bitwise that lane's context by construction).  Per-lane
    scalars become (L, 1) columns that broadcast against (L, N) rows;
    python-float constants stay as they are.  ``minmax`` as in
    ``frozen_ctx``."""
    L = fleet.capacity.shape[0]
    ems = energy if isinstance(energy, (list, tuple)) else [energy] * L
    per = [frozen_ctx(_lane(fleet, l), weights, horizon_h, energy=ems[l],
                      minmax=minmax)
           for l in range(L)]
    ctx = {}
    for k, v in per[0].items():
        if not isinstance(v, torch.Tensor):
            ctx[k] = v
            continue
        x = torch.stack([c[k] for c in per])
        ctx[k] = x[:, None] if x.dim() == 1 else x
    return ctx


def _one_score_b(cap_b: torch.Tensor, b: torch.Tensor, ctx,
                 w: RankWeights) -> torch.Tensor:
    """Per-lane O(1) rescore: lane l's node ``b[l]`` at free chips
    ``cap_b[l]`` — ``_one_score`` gathered per lane, bitwise per lane.
    ``b`` may hold the padding id N where the result is not used."""
    n = ctx["a_now"].shape[1]
    idx = b.clamp(0, n - 1)[:, None]
    g = {k: (v.gather(1, idx) if k in _GATHERED else v)
         for k, v in ctx.items()}
    return _ctx_scores(cap_b[:, None], g, w)[:, 0]


def _batched_sweep(fleet: Fleet, ctx, weights: RankWeights,
                   horizon_h: float, use_kernel: bool, k_cand: int):
    """One round's sweep for every lane: cap (L, N) -> (scores (L, N), top
    (K+1) scores, their node ids), each lane in (score, node index) order."""
    from repro_torch.kernels.ops import lex_head, maiz_ranking_topk_batched

    if not use_kernel:
        def sweep(cap):
            scores = _ctx_scores(cap, ctx, weights)
            top_s, idx = lex_head(scores, k_cand)
            return scores, top_s, idx.to(torch.int32)
        return sweep

    # the sequential engine's stream threading, one lane axis wider: ec
    # from the lanes' own idle/dynamic fractions (the values frozen_ctx
    # holds), the marginal term via pk/cap/ct + the per-lane (L, 4) en
    lane_em = EnergyModel(idle_frac=ctx["idle_f"], dyn_frac=ctx["dyn_f"])
    L, dev = fleet.capacity.shape[0], fleet.capacity.device

    def col(k):
        v = ctx[k]
        return v if isinstance(v, torch.Tensor) else torch.full(
            (L, 1), v, dtype=torch.float32, device=dev)

    mkw = {}
    if "m_dyn" in ctx:
        mkw = dict(pk=fleet.power_kw * horizon_h, chips_total=ctx["ct_f"],
                   en=torch.cat([col(k) for k in ("idle_f", "dyn_f",
                                                  "emb_h", "w_m")], dim=1))
    sched = fleet.sched_term
    w_arr = weights.as_array(fleet.capacity.device)

    def sweep(cap):
        ec = fleet.effective_power_kw(cap, energy=lane_em) * horizon_h
        kw = dict(mkw, cap=cap.to(torch.float32)) if mkw else {}
        return maiz_ranking_topk_batched(
            ec, fleet.pue, fleet.ci_now, fleet.ci_forecast,
            fleet.flops_per_j, sched, w_arr, k=k_cand, lohi=ctx["lohi"],
            **kw)
    return sweep


def place_lifecycle_batched(fleet: Fleet, demands: torch.Tensor,
                            weights: RankWeights = RankWeights(),
                            horizon_h: float = 1.0, *,
                            engine: str = "shortlist", shortlist: int = 32,
                            use_kernel: bool = False,
                            capacity: Optional[torch.Tensor] = None,
                            n_events: Optional[torch.Tensor] = None,
                            energy: Union[None, EnergyModel,
                                          Sequence[EnergyModel]] = None,
                            syncs: Optional[HostSyncs] = None,
                            split: Optional[NodeSplit] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Arrival-only lifecycle placement over a leading lane axis — the
    batched twin of ``place_lifecycle_shortlist`` (with ``eager_sweep``)
    and ``place_lifecycle_full_rerank`` (``engine="full"``).

    ``fleet`` carries (L, N) leaves, ``demands`` is (L, E) arrival chips
    (pads 0), ``capacity`` the (L, N) starting capacity (the normalizers
    stay frozen at ``fleet.capacity``), ``n_events`` the (L,) event counts,
    ``energy`` one model for all lanes or one per lane.  Returns (node
    (L, E), capacity (L, N), n_sweeps (L,)): per lane the sequential
    engine's decisions, tie-breaks and sweep counts.

    Two nested loops with any-reduced conditions (one host read each,
    counted in ``syncs``): the inner walk consumes events with O(K)
    shortlist work per lane per step, and a lane whose event needs a
    fresh sweep stalls; the outer round runs one batched sweep (the rank
    kernel K4 with ``use_kernel``) and lands every stalled lane's event
    from it on that lane's current capacity.  The walk reads only the
    shortlist's capacity mirror ``slcap`` and the round's ``cap_max``;
    its placements reach ``cap`` as one scatter per round.  The sweep
    scores every lane each round and is applied where ``need`` is set.

    ``split``: this rank runs its ``NodeSplit`` slice of the node axis:
    the fleet's leaves and ``capacity`` are this rank's (L, n) slices,
    and so is the capacity returned; node ids (``node``, the shortlist)
    are global, and the results are the same on every rank of the
    split's group."""
    if engine not in ("shortlist", "full"):
        raise ValueError(f"unknown batched engine: {engine!r}")
    syncs = HostSyncs() if syncs is None else syncs
    ax = WholeAxis() if split is None else split
    L, n = fleet.capacity.shape
    N = ax.n_total(n)
    if capacity is None:
        capacity = fleet.capacity
    E = demands.shape[1]
    dev = fleet.capacity.device
    K = min(max(shortlist, 1), N)
    k_cand = min(K + 1, N)
    full_cover = K >= N
    inf = torch.tensor(torch.inf, device=dev)
    lanes = torch.arange(L, device=dev)
    karange = torch.arange(K, device=dev)
    ctx = stacked_ctx(fleet, weights, horizon_h, energy, ax.minmax)
    cap = capacity.to(torch.int32).clone()
    healthy = fleet.healthy
    demands = demands.to(torch.int64)
    n_ev = torch.full((L,), E, device=dev) if n_events is None \
        else n_events.to(torch.int64)
    out = torch.full((L, E), -1, dtype=torch.int64, device=dev)
    sweeps = torch.zeros(L, dtype=torch.int64, device=dev)

    def hmax(c):
        return ax.amax(torch.where(healthy, c, 0))

    def ev_demand(ptr):
        p = ptr.clamp(max=E - 1)
        return p, demands.gather(1, p[:, None])[:, 0]

    def land(scores, d):
        """Each lane's masked argmin over ``scores`` on its current
        capacity: (best node, whether it is feasible)."""
        masked = torch.where((cap >= d[:, None]) & healthy, scores, inf)
        best, m = ax.argmin(masked)
        return best, torch.isfinite(m)

    if engine == "full":
        # the O(L·N) oracle: every live arrival is one batched rescore
        n_max = int(n_ev.max())
        syncs.n += 1
        for e in range(n_max):
            d = demands[:, e]
            live = (e < n_ev) & (d > 0)
            best, ok = land(_ctx_scores(cap, ctx, weights), d)
            ok = live & ok
            ax.add_at(cap, best[:, None],
                      torch.where(ok, -d, 0).to(torch.int32)[:, None])
            out[:, e] = torch.where(ok, best, out[:, e])
            sweeps += live.to(torch.int64)
        return out, cap, sweeps

    sweep_topk = _batched_sweep(fleet, ctx, weights, horizon_h, use_kernel,
                                k_cand)
    slcap = ax.take(cap, torch.full((L, K), N - 1, device=dev))
    sl_s = torch.full((L, K), torch.inf, device=dev)
    sl_i = torch.full((L, K), N, dtype=torch.int64, device=dev)
    bound_s = torch.full((L,), torch.inf, device=dev)
    bound_i = torch.full((L,), N, dtype=torch.int64, device=dev)
    cap_max = hmax(cap)
    dirty = torch.ones(L, dtype=torch.bool, device=dev)
    ptr = torch.zeros(L, dtype=torch.int64, device=dev)
    ptr0 = ptr.clone()
    need = torch.zeros(L, dtype=torch.bool, device=dev)
    seg = torch.arange(E, device=dev)[None, :]

    while syncs.any((ptr < n_ev) | need):
        slh = ax.take(healthy, sl_i.clamp(max=N - 1))
        # ---- inner walk: O(K) per lane per event, stalls on a sweep ----
        while syncs.any((ptr < n_ev) & ~need):
            act = (ptr < n_ev) & ~need
            p, d = ev_demand(ptr)
            is_arr = act & (d > 0)
            sm = torch.where((slcap >= d[:, None]) & slh, sl_s, inf)
            m = sm.amin(1)
            kbest = torch.argmin(torch.where(sm == m[:, None], sl_i, N), 1)
            bnode = sl_i.gather(1, kbest[:, None])[:, 0]
            feasible = torch.isfinite(m)
            beats = (m < bound_s) | ((m == bound_s) & (bnode < bound_i))
            use_sl = ~dirty & feasible & beats
            dead = (d > cap_max) | (~dirty & ~feasible
                                    & ~torch.isfinite(bound_s))
            place_sl = is_arr & use_sl
            stall = is_arr & ~use_sl & ~dead
            cap_b = slcap.gather(1, kbest[:, None])[:, 0] - d
            new_s = ax.rescore(cap_b, bnode, ctx, weights)
            hit = place_sl[:, None] & (karange[None, :] == kbest[:, None])
            sl_s = torch.where(hit, new_s[:, None], sl_s)
            slcap = torch.where(hit, slcap - d[:, None].to(slcap.dtype),
                                slcap)
            out[lanes, p] = torch.where(place_sl, bnode, out[lanes, p])
            ptr = torch.where(act & ~stall, ptr + 1, ptr)
            need = need | stall
        # the walk's placements (events [ptr0, ptr) that landed) reach the
        # full capacity as one scatter-add
        newly = (seg >= ptr0[:, None]) & (seg < ptr[:, None]) & (out >= 0)
        ax.add_at(cap, out.clamp(0, N - 1),
                  torch.where(newly, -demands, 0).to(torch.int32))
        # ---- round boundary: one sweep for every lane, applied where a
        # lane stalled (at that lane's current capacity) -----------------
        scores, cand_s, cand_i = sweep_topk(cap)
        cand_s, cand_i = ax.merge(cand_s, cand_i.to(torch.int64), k_cand)
        p, d = ev_demand(ptr)
        best, ok = land(scores, d)
        cap_b = ax.take(cap, best[:, None])[:, 0] - d
        new_s = ax.rescore(cap_b, best, ctx, weights)
        sl_s2, sl_i2 = cand_s[:, :K], cand_i[:, :K]
        if full_cover:
            bound_s2 = torch.full((L,), torch.inf, device=dev)
            bound_i2 = torch.full((L,), N, dtype=torch.int64, device=dev)
        else:
            bound_s2, bound_i2 = cand_s[:, K], cand_i[:, K]
        sl_s2 = torch.where(ok[:, None] & (sl_i2 == best[:, None]),
                            new_s[:, None], sl_s2)
        cm2 = hmax(cap)                  # pre-placement, as in land_from
        out[lanes, p] = torch.where(need, torch.where(ok, best, -1),
                                    out[lanes, p])
        ax.add_at(cap, best[:, None], torch.where(
            need & ok, -d, 0).to(torch.int32)[:, None])
        slcap2 = ax.take(cap, sl_i2)
        col = need[:, None]
        slcap = torch.where(col, slcap2, slcap)
        sl_s = torch.where(col, sl_s2, sl_s)
        sl_i = torch.where(col, sl_i2, sl_i)
        bound_s = torch.where(need, bound_s2, bound_s)
        bound_i = torch.where(need, bound_i2, bound_i)
        cap_max = torch.where(need, cm2, cap_max)
        sweeps += need.to(torch.int64)
        dirty = dirty & ~need
        ptr = torch.where(need, ptr + 1, ptr)
        ptr0 = ptr
        need = torch.zeros_like(need)
    return out, cap, sweeps
