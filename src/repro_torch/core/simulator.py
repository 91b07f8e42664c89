"""Rolling multi-epoch fleet simulator: arrivals, departures, migration
(torch twin of ``repro.core.simulator``'s host loop).

Each hourly epoch:

1. reads ``ci_now`` from per-region traces and, when the FCFP weight is
   on, fits the forecaster on the trailing ``history_h`` window;
2. releases finished jobs;
3. migrates the worst-placed running jobs when the reactive policy's gain
   beats the checkpoint carbon (``migration_budget`` per epoch), and
   force-evicts jobs from outaged regions;
4. admits the seeded arrival stream (deferrable jobs may wait for a
   greener hour), placing every event through ONE lifecycle-engine call;
5. accounts emissions in f64 numpy on the host.

Steps 1 and 4's placement run on the fleet's device (the rank kernel when
``use_kernel``); the job bookkeeping and the accounting are the
reference's numpy code, so the same placements give the same emissions.
``engine="blind"``/``"spread"`` are the carbon-blind comparators.
``paper_scenario_alloc`` is the paper experiment as the N=3 / T=8760
special case.

Not ported yet (raise ``NotImplementedError``): signal faults, serving
traffic, tenants and SLO deferral (ROADMAP Queue 1 item 7), the look-ahead
planner (items 6-7), the scanned driver and the ensemble (items 8-9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import forecast, telemetry
from repro_torch.core import policy as policylib
from repro_torch.core.energy import DEFAULT_ENERGY, EnergyModel
from repro_torch.core.fleet import Fleet, fleet_tensors
from repro_torch.core.placement import (place_lifecycle_full_rerank,
                                        place_lifecycle_shortlist)
from repro_torch.core.policy import Policy, PolicyConfig
from repro_torch.core.ranking import RankWeights

# job state machine
_PENDING, _ACTIVE, _DONE, _DROPPED = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class SimConfig:
    epochs: int = 168
    seed: int = 0
    weights: RankWeights = RankWeights()
    engine: str = "shortlist"       # shortlist | full | blind | spread
    shortlist: int = 64
    use_kernel: bool = False
    horizon_h: int = 24             # FCFP forecast horizon
    history_h: int = 336            # trailing window fed to the forecaster
    # --- arrival process (seeded, deterministic) ---
    arrival_rate: float = 12.0      # mean arrivals / epoch
    diurnal: bool = True            # business-hours modulation
    flash_crowd: Optional[Tuple[int, int, float]] = None  # (t0, len, mult)
    # one (region, t0, len) window, or a sequence of such windows
    outage: Optional[Tuple[int, int, int]] = None
    mean_duration_h: float = 12.0
    chips_lo: int = 8
    chips_hi: int = 64
    deferrable_frac: float = 0.0    # batch jobs that can wait for green hours
    defer_max_h: int = 6
    policy: PolicyConfig = PolicyConfig()
    # not ported yet; anything but None raises (ROADMAP Queue 1 item 7)
    faults: Optional[Any] = None
    traffic: Optional[Any] = None
    # --- migration ---
    migration_budget: int = 0       # max policy migrations / epoch
    migration_overhead_h: float = 0.05   # checkpoint+restore wall clock
    # --- power model ---
    energy: EnergyModel = DEFAULT_ENERGY
    power_off_idle: bool = True     # nodes with no jobs draw zero
    n_tenants: int = 0              # not ported yet (> 0 raises)
    # straggler bonus of powered-off nodes, so SCHEDULE_WEIGHT favours
    # consolidation onto already-on nodes; 0 disables
    consolidate: float = 1.0

    @property
    def use_forecast(self) -> bool:
        return self.weights.w2 != 0.0


def _check_ported(cfg: SimConfig) -> None:
    """Raise on every option this slice of the port does not run."""
    todo = [(cfg.faults is not None, "faults (signal faults)", "7"),
            (cfg.traffic is not None, "traffic (serving requests)", "7"),
            (cfg.n_tenants > 0, "n_tenants (tenant attribution)", "7"),
            (cfg.policy.deferral == "slo", "policy.deferral='slo'", "7"),
            (cfg.policy.migration == "lookahead",
             "policy.migration='lookahead'", "6-7")]
    for hit, what, item in todo:
        if hit:
            raise NotImplementedError(
                f"SimConfig.{what} is not ported to repro_torch yet "
                f"(ROADMAP Queue 1 item {item})")


def _outage_windows(outage) -> Tuple[Tuple[int, int, int], ...]:
    """``SimConfig.outage`` as a tuple of (region, t0, len) windows."""
    if outage is None:
        return ()
    if len(outage) == 3 and all(
            isinstance(v, (int, np.integer)) for v in outage):
        return (tuple(int(v) for v in outage),)
    return tuple(tuple(int(v) for v in w) for w in outage)


@dataclasses.dataclass
class JobSchedule:
    """Struct-of-arrays over jobs, sorted by arrival epoch."""
    arrive: np.ndarray      # (J,) epoch of arrival
    chips: np.ndarray       # (J,) chip demand
    duration: np.ndarray    # (J,) epochs of runtime
    load: np.ndarray        # (J,) float dynamic load (util accounting)
    deferrable: np.ndarray  # (J,) bool
    deadline: Optional[np.ndarray] = None   # (J,) start slack in epochs
    value: Optional[np.ndarray] = None      # (J,) f32 job value

    @property
    def n(self) -> int:
        return self.arrive.shape[0]


def generate_jobs(cfg: SimConfig) -> JobSchedule:
    """Seeded stochastic arrival stream: Poisson with diurnal modulation and
    an optional flash crowd; geometric durations; uniform chip demands.
    The reference's numpy draws in the reference's order."""
    _check_ported(cfg)
    rng = np.random.default_rng(np.uint64(cfg.seed) * np.uint64(977) + 13)
    t = np.arange(cfg.epochs)
    rate = np.full(cfg.epochs, float(cfg.arrival_rate))
    if cfg.diurnal:
        rate *= 1.0 + 0.4 * np.cos(2 * np.pi * (t % 24 - 14) / 24)
    if cfg.flash_crowd is not None:
        t0, length, mult = cfg.flash_crowd
        rate[t0:t0 + length] *= mult
    counts = rng.poisson(rate)
    arrive = np.repeat(t, counts)
    J = arrive.shape[0]
    chips = rng.integers(cfg.chips_lo, cfg.chips_hi + 1, J)
    # duration = 1 + Geometric(p); p clamped into (0, 1]
    p = min(1.0, 1.0 / max(cfg.mean_duration_h - 1.0, 1e-9))
    duration = 1 + rng.geometric(p, J) \
        if cfg.mean_duration_h > 1.0 else np.ones(J, np.int64)
    deferrable = rng.random(J) < cfg.deferrable_frac
    return JobSchedule(arrive=arrive, chips=chips.astype(np.int64),
                       duration=duration.astype(np.int64),
                       load=chips.astype(np.float64),
                       deferrable=deferrable)


@dataclasses.dataclass
class SimResult:
    emissions_g: float              # total, incl. migration overhead
    migration_cost_g: float
    rank_sweeps: int
    arrivals_placed: int            # arrival events landed (re-placements too)
    jobs_completed: int
    jobs_dropped: int
    jobs_deferred: int              # deferral decisions taken
    migrations: int
    evictions: int
    node_log: np.ndarray            # (J,) final node per job (-1 = dropped)
    first_node: np.ndarray          # (J,) first placement per job
    emissions_series: np.ndarray    # (T,) gCO2 per epoch
    deadline_misses: int = 0        # slack>0 jobs that never started in time
    defer_delay_h: int = 0          # sum of (start - arrive) over placements
    migrations_failed: int = 0      # actuation failures (faults only)
    jobs_active_end: int = 0        # still running when the horizon ends
    safe_epochs: int = 0            # epochs spent with policy frozen (faults)
    start_epoch: Optional[np.ndarray] = None  # (J,) first-placement epoch
    util: Optional[np.ndarray] = None   # (N, T) when record_matrices
    on: Optional[np.ndarray] = None


# ---------------------------------------------------------------------------
# epoch step: slice traces -> forecast -> build fleet -> place events
# ---------------------------------------------------------------------------


def _place_epoch(pue, power_kw, chips_total, straggler, flops_per_j,
                 ci_now, ci_fc, cap_ctx, cap_start, healthy, demands, nodes,
                 statics, n_events=None, eager_sweep=False, energy=None):
    """Build the epoch Fleet and run the lifecycle placement engine.
    ``cap_ctx`` is the snapshot the frozen normalizers see, ``cap_start``
    where the event loop begins."""
    engine, shortlist, use_kernel, weights = statics[:4]
    fleet = Fleet(ci_now=ci_now.to(torch.float32),
                  ci_forecast=ci_fc.to(torch.float32),
                  pue=pue, power_kw=power_kw, capacity=cap_ctx,
                  healthy=healthy, straggler_score=straggler,
                  flops_per_j=flops_per_j, chips_total=chips_total)
    if engine == "full":
        r = place_lifecycle_full_rerank(fleet, demands, nodes, weights,
                                        horizon_h=1.0, capacity=cap_start,
                                        n_events=n_events, energy=energy)
    else:
        r = place_lifecycle_shortlist(fleet, demands, nodes, weights,
                                      horizon_h=1.0, shortlist=shortlist,
                                      use_kernel=use_kernel,
                                      capacity=cap_start,
                                      n_events=n_events,
                                      eager_sweep=eager_sweep,
                                      energy=energy)
    return r.node, r.capacity, r.n_sweeps


def _epoch_core(traces, ridx, pue, power_kw, chips_total, straggler,
                flops_per_j, region_pue, t, cap, healthy, demands, nodes,
                statics, energy=None):
    """One simulator epoch on the device: slice the CI column, refresh the
    FCFP forecast, build the Fleet and run the lifecycle placement engine.
    ``straggler`` already carries the per-epoch consolidation bonus.
    Returns (node, capacity, n_sweeps, ci_now, cur_rate, fut_rate)."""
    (engine, shortlist, use_kernel, weights, horizon_h, history_h,
     use_forecast, defer_window) = statics
    ci_now = traces[:, t][ridx]
    if use_forecast:
        window = traces[:, t - history_h:t]
        fc, _ = forecast.forecast_regions(window, horizon_h, 0)  # (R, H)
        ci_fc = torch.mean(fc, dim=-1)[ridx]
        # greenest achievable CFP rate inside the deferral window; node-less
        # regions are masked (a clamped 0.0 forecast times +inf is NaN)
        fut_rate = torch.where(torch.isfinite(region_pue)[:, None],
                               fc[:, :defer_window] * region_pue[:, None],
                               torch.inf).min()
    else:
        ci_fc = ci_now
        fut_rate = torch.tensor(torch.inf, device=traces.device)
    node, cap_out, n_sweeps = _place_epoch(
        pue, power_kw, chips_total, straggler, flops_per_j, ci_now, ci_fc,
        cap, cap, healthy, demands, nodes, statics, energy=energy)
    cur_rate = torch.where(healthy, ci_now * pue, torch.inf).min()
    return node, cap_out, n_sweeps, ci_now, cur_rate, fut_rate


def _region_pue(n_regions: int, ridx: np.ndarray, pue) -> np.ndarray:
    """Representative PUE per region row; regions with no nodes get +inf so
    they can't win the deferral policy's "greenest upcoming hour" min."""
    out = np.full(n_regions, np.inf)
    np.minimum.at(out, ridx, np.asarray(pue, np.float64))
    return out


def _pad_bucket(n: int) -> int:
    """Round the event count up to a small set of sizes (the reference's
    compile buckets; kept so event buffers have the same layout)."""
    b = 8
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------


def simulate_fleet(fleet0: Fleet, region_ci: np.ndarray, ridx: np.ndarray,
                   cfg: SimConfig, jobs: Optional[JobSchedule] = None,
                   record_matrices: bool = False) -> SimResult:
    """Advance ``fleet0`` (capacity = free chips at t=0) through
    ``cfg.epochs`` hourly epochs on ``fleet0``'s device.

    ``region_ci`` is (R, history_h + epochs + margin) hourly CI; nodes map
    to regions via ``ridx``.  Epoch t reads column ``history_h + t`` as
    ``ci_now`` and feeds the trailing ``history_h`` window to the FCFP
    forecaster.  ``jobs`` defaults to ``generate_jobs(cfg)``."""
    _check_ported(cfg)
    N, T = fleet0.n, cfg.epochs
    jobs = jobs if jobs is not None else generate_jobs(cfg)
    J = jobs.n
    if cfg.engine not in ("shortlist", "full", "blind", "spread"):
        raise ValueError(f"unknown simulator engine: {cfg.engine!r}")
    blind = cfg.engine in ("blind", "spread")
    spread = cfg.engine == "spread"
    rr_ptr = [0]                            # round-robin pointer (spread)
    pol = Policy.for_jobs(cfg.policy, jobs.arrive, jobs.deferrable,
                          cfg.defer_max_h, jobs.deadline, jobs.value)
    green_factor = float(cfg.policy.defer_green_factor)
    outs = _outage_windows(cfg.outage)
    dev = fleet0.device

    region_ci = np.asarray(region_ci)
    ridx = np.asarray(ridx)
    traces = torch.from_numpy(region_ci.astype(np.float32)).to(dev)
    ridx_d = torch.from_numpy(ridx.astype(np.int64)).to(dev)

    # host mirrors for policy + accounting (f64)
    pue_h = fleet0.pue.cpu().numpy().astype(np.float64)
    power_h = fleet0.power_kw.cpu().numpy().astype(np.float64)
    chips_total_h = fleet0.chips_total.cpu().numpy().astype(np.int64)
    healthy0 = fleet0.healthy.cpu().numpy().astype(bool)
    strag_h = fleet0.straggler_score.cpu().numpy().astype(np.float64)
    region_pue_d = torch.from_numpy(_region_pue(
        region_ci.shape[0], ridx, pue_h).astype(np.float32)).to(dev)

    cap = fleet0.capacity
    cap_h = cap.cpu().numpy().astype(np.int64)
    njobs = np.zeros(N, np.int64)          # running jobs per node
    load_on = np.zeros(N, np.float64)      # dynamic load per node

    # job table
    jnode = np.full(J, -1, np.int64)
    jfirst = np.full(J, -1, np.int64)
    jstart = np.full(J, -1, np.int64)
    jend = np.full(J, -1, np.int64)
    jstate = np.full(J, _PENDING, np.int8)
    ends: Dict[int, list] = {}
    by_arrival: Dict[int, list] = {}
    for j in range(J):
        by_arrival.setdefault(int(jobs.arrive[j]), []).append(j)
    deferred: Dict[int, list] = {}

    emissions = 0.0
    mig_cost_total = 0.0
    sweeps = placed = completed = dropped = deferred_n = 0
    migrations = evictions = misses = delay_h = 0
    series = np.zeros(T)
    util_m = np.zeros((N, T)) if record_matrices else None
    on_m = np.zeros((N, T)) if record_matrices else None

    # the live marginal weight rides in the EnergyModel (f32 on the
    # device), the weights with marginal pinned to 0
    em_host = cfg.energy
    em_dev = em_host.device(w_marginal=cfg.weights.marginal, device=dev)
    statics = (cfg.engine, cfg.shortlist, cfg.use_kernel,
               cfg.weights.graph_key(),
               cfg.horizon_h, cfg.history_h,
               cfg.use_forecast and not blind,
               pol.defer_window(cfg.defer_max_h))
    overhead_s = cfg.migration_overhead_h * 3600.0

    def epoch_step(a, dem, tgt):
        return _epoch_core(
            traces, ridx_d, fleet0.pue, fleet0.power_kw, fleet0.chips_total,
            strag, fleet0.flops_per_j, region_pue_d, a, cap,
            healthy_d, dem, tgt, statics, em_dev)

    for t in range(T):
        a = cfg.history_h + t
        ci_col = region_ci[:, a][ridx]      # (N,) f64 (accounting + policy)
        healthy = healthy0.copy()
        for reg, t0, length in outs:
            if t0 <= t < t0 + length:
                healthy &= (ridx != reg)

        # ---- 1. end-of-life releases --------------------------------
        rel_jobs = [j for j in ends.pop(t, []) if jstate[j] == _ACTIVE]
        for j in rel_jobs:
            jstate[j] = _DONE
            completed += 1
            njobs[jnode[j]] -= 1
            load_on[jnode[j]] -= jobs.load[j]

        # ---- 2. forced evictions + migration policy -----------------
        active = np.where(jstate == _ACTIVE)[0]
        evict = active[~healthy[jnode[active]]] if outs \
            else np.empty(0, np.int64)
        mig: list = []
        if cfg.migration_budget > 0 and not blind and active.size:
            stay = active[healthy[jnode[active]]]
            free = cap_h.copy()
            rate = np.where(healthy, pue_h * ci_col, np.inf)
            # best achievable CFP rate per distinct chip demand, O(C·N)
            best_rate: Dict[int, float] = {}
            for c in np.unique(jobs.chips[stay]):
                feas = rate[free >= c]
                best_rate[int(c)] = float(feas.min()) if feas.size else np.inf
            chips_arr = jobs.chips[stay]
            br_arr = np.array([best_rate[int(c)] for c in chips_arr]) \
                if stay.size else np.empty(0)
            gain = policylib.migration_gain(
                np, cfg.policy,
                rate_cur=rate[jnode[stay]], best_rate=br_arr,
                chips=chips_arr,
                remaining=np.maximum(jend[stay] - t, 0),
                e_kwh_h=float(em_host.e_kwh_h),
                ckpt=np.asarray(em_host.job_energy_kwh(overhead_s, 1,
                                                       chips_arr)))
            order = np.argsort(-gain, kind="stable")
            for i in order[:cfg.migration_budget]:
                if gain[i] > 0.0:
                    mig.append(int(stay[i]))
        migrations += len(mig)
        evictions += evict.size
        movers = list(evict) + mig
        for j in movers:
            njobs[jnode[j]] -= 1
            load_on[jnode[j]] -= jobs.load[j]
            if j in mig:
                mig_cost_total += (float(em_host.job_energy_kwh(
                    overhead_s, 1, int(jobs.chips[j])))
                    * pue_h[jnode[j]] * ci_col[jnode[j]])

        # ---- 3. new arrivals (+ deferral policy) --------------------
        arr_jobs = deferred.pop(t, []) + by_arrival.pop(t, [])
        ev_d = ([-int(jobs.chips[j]) for j in rel_jobs]
                + [-int(jobs.chips[j]) for j in movers]
                + [int(jobs.chips[j]) for j in movers]
                + [int(jobs.chips[j]) for j in arr_jobs])
        ev_n = ([int(jnode[j]) for j in rel_jobs]
                + [int(jnode[j]) for j in movers]
                + [-1] * (len(movers) + len(arr_jobs)))
        E = _pad_bucket(max(len(ev_d), 1))
        dem = np.zeros(E, np.int32)
        tgt = np.full(E, -1, np.int32)
        dem[:len(ev_d)] = ev_d
        tgt[:len(ev_n)] = ev_n
        arr_off = len(rel_jobs) + 2 * len(movers)

        if blind:
            out, cap_h = _place_blind(dem, tgt, cap_h, healthy, rr_ptr,
                                      spread)
            cap = torch.from_numpy(cap_h.astype(np.int32)).to(dev)
            cur_rate = fut_rate = np.inf
        else:
            strag = torch.from_numpy(
                (strag_h + cfg.consolidate * (njobs == 0)).astype(
                    np.float32)).to(dev)
            healthy_d = torch.from_numpy(healthy).to(dev)
            out, cap, n_sw, _, cur_rate, fut_rate = epoch_step(a, dem, tgt)
            out = out.cpu().numpy()
            cap_h = cap.cpu().numpy().astype(np.int64)
            sweeps += int(n_sw)
            cur_rate, fut_rate = torch.stack([cur_rate, fut_rate]).tolist()

        # ---- 4. record outcomes -------------------------------------
        # deferrable jobs whose green hour is coming release their slot
        # again (re-run next epoch); done post-hoc so the event stream
        # stays identical across engines
        green_later = bool(policylib.wants_defer(fut_rate, cur_rate,
                                                 green_factor))
        redo_d, redo_n = [], []
        for i, j in enumerate(movers + arr_jobs):
            node = int(out[arr_off - len(movers) + i]) if i < len(movers) \
                else int(out[arr_off + (i - len(movers))])
            is_new = i >= len(movers)
            if is_new:
                defer_now = bool(jobs.deferrable[j]) \
                    and (t - int(jobs.arrive[j])) < cfg.defer_max_h \
                    and (green_later if node >= 0 else True)
                if defer_now:
                    if node >= 0:
                        # take the placement back: defer to next epoch
                        redo_d.append(-int(jobs.chips[j]))
                        redo_n.append(node)
                    deferred.setdefault(t + 1, []).append(j)
                    deferred_n += 1
                    continue
            if node < 0:
                jstate[j] = _DROPPED
                dropped += 1
                if is_new and pol.slack[j] > 0:
                    misses += 1
                continue
            if jstate[j] != _ACTIVE:       # first placement
                jstate[j] = _ACTIVE
                jend[j] = t + int(jobs.duration[j])
                ends.setdefault(int(jend[j]), []).append(j)
                if jfirst[j] < 0:
                    jfirst[j] = node
                jstart[j] = t
                delay_h += t - int(jobs.arrive[j])
            jnode[j] = node
            njobs[node] += 1
            load_on[node] += jobs.load[j]
            placed += 1
        if redo_d:
            E2 = _pad_bucket(len(redo_d))
            d2 = np.zeros(E2, np.int32)
            n2 = np.full(E2, -1, np.int32)
            d2[:len(redo_d)] = redo_d
            n2[:len(redo_n)] = redo_n
            if blind:
                _, cap_h = _place_blind(d2, n2, cap_h, healthy, rr_ptr,
                                        spread)
                cap = torch.from_numpy(cap_h.astype(np.int32)).to(dev)
            else:
                _, cap, _, _, _, _ = epoch_step(a, d2, n2)
                cap_h = cap.cpu().numpy().astype(np.int64)

        # ---- 5. emission accounting ---------------------------------
        # the spread comparator models the paper's baseline: all nodes on
        on = (njobs > 0) if cfg.power_off_idle and not spread \
            else np.ones(N, bool)
        occ = 1.0 - cap_h / np.maximum(chips_total_h, 1)
        energy_kwh = power_h * (em_host.idle_frac
                                + em_host.dyn_frac * occ) * on
        # two-part carbon: operational (Eq. 2) + amortized embodied per
        # on-node-hour; embodied == 0.0 adds exact zeros
        node_g = (energy_kwh * pue_h * ci_col
                  + em_host.embodied_g_per_node_h * on)
        series[t] = float(np.sum(node_g))
        emissions += series[t]
        if record_matrices:
            util_m[:, t] = load_on
            on_m[:, t] = on.astype(np.float64)

    # jobs still waiting in the deferral queue when the horizon ends were
    # never run: account them as dropped and as deadline misses
    for pending in deferred.values():
        for j in pending:
            if jstate[j] == _PENDING:
                jstate[j] = _DROPPED
                dropped += 1
                misses += 1

    emissions += mig_cost_total
    return SimResult(emissions_g=emissions, migration_cost_g=mig_cost_total,
                     rank_sweeps=sweeps, arrivals_placed=placed,
                     jobs_completed=completed, jobs_dropped=dropped,
                     jobs_deferred=deferred_n, migrations=migrations,
                     evictions=evictions, node_log=jnode, first_node=jfirst,
                     emissions_series=series, deadline_misses=misses,
                     defer_delay_h=delay_h,
                     jobs_active_end=int((jstate == _ACTIVE).sum()),
                     start_epoch=jstart, util=util_m, on=on_m)


def _place_blind(dem: np.ndarray, tgt: np.ndarray, cap: np.ndarray,
                 healthy: np.ndarray, rr_ptr: list, spread: bool
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Carbon-blind lifecycle comparators: lowest-index first-fit
    (consolidating), or round-robin from a rotating pointer (spreading,
    the paper's baseline policy)."""
    cap = cap.copy()
    N = cap.shape[0]
    out = np.full(dem.shape[0], -1, np.int64)
    for e in range(dem.shape[0]):
        d = int(dem[e])
        if d < 0:
            cap[tgt[e]] -= d
            out[e] = tgt[e]
        elif d > 0:
            feas = np.nonzero((cap >= d) & healthy)[0]
            if not feas.size:
                continue
            if spread:
                nxt = feas[feas >= rr_ptr[0]]
                pick = int(nxt[0]) if nxt.size else int(feas[0])
                rr_ptr[0] = (pick + 1) % N
            else:
                pick = int(feas[0])
            out[e] = pick
            cap[pick] -= d
    return out, cap


# ---------------------------------------------------------------------------
# synthetic lifecycle fleet (traces + node arrays)
# ---------------------------------------------------------------------------


def synthetic_lifecycle_fleet(n: int, cfg: SimConfig,
                              chips_per_node: int = 256,
                              region: Optional[int] = None, *,
                              device: DeviceLike = None
                              ) -> Tuple[Fleet, np.ndarray, np.ndarray]:
    """(empty fleet, region CI traces, node->region map) for the simulator:
    the reference's recipe and numpy draws, capacity starting FULL and the
    traces carrying ``history_h`` hours of warm-up for the forecaster."""
    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    regions = list(telemetry.REGIONS.values())
    ridx = rng.integers(0, len(regions), n) if region is None \
        else np.full(n, int(region))
    hours = cfg.history_h + cfg.epochs + cfg.horizon_h + 1
    traces = np.stack([telemetry.hourly_ci(r, hours=hours, seed=cfg.seed + i)
                       for i, r in enumerate(regions)])
    power_kw = chips_per_node * cfg.energy.chip_kw * (1 + 0.1 * rng.random(n))
    straggler = np.abs(rng.normal(0, 0.05, n))
    flops = 788e9 * (1 + 0.05 * rng.standard_normal(n))
    fleet = fleet_tensors(
        dev, ci_now=traces[ridx, cfg.history_h],
        ci_forecast=traces[ridx, cfg.history_h],
        pue=np.array([r.pue for r in regions])[ridx], power_kw=power_kw,
        capacity=np.full(n, chips_per_node), healthy=np.ones(n, bool),
        straggler_score=straggler, flops_per_j=flops,
        chips_total=np.full(n, chips_per_node))
    return fleet, traces, ridx


# ---------------------------------------------------------------------------
# the paper experiment as a simulator special case
# ---------------------------------------------------------------------------

_PAPER_CHIPS = 60      # one unit = 60 servers; the job takes the whole node


def paper_scenario_alloc(ci: np.ndarray, pue: np.ndarray, demand: float, *,
                         device: DeviceLike = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Scenario C (util, on) matrices via the rolling simulator: one
    1-epoch job per hour carries the aggregate dynamic demand, CFP-only
    weights, idle power-off — the paper's active-shifting policy through
    the same lifecycle code path that runs large fleets."""
    dev = resolve_device(device)
    N, T = ci.shape
    cfg = SimConfig(epochs=T, seed=0,
                    weights=RankWeights(w1=1.0, w2=0.0, w3=0.0, w4=0.0),
                    engine="full", history_h=0, horizon_h=1,
                    migration_budget=0, power_off_idle=True)
    ones = np.ones(N)
    fleet = fleet_tensors(
        dev, ci_now=ci[:, 0], ci_forecast=ci[:, 0], pue=pue, power_kw=ones,
        capacity=np.full(N, _PAPER_CHIPS), healthy=np.ones(N, bool),
        straggler_score=np.zeros(N), flops_per_j=ones,
        chips_total=np.full(N, _PAPER_CHIPS))
    jobs = JobSchedule(arrive=np.arange(T),
                       chips=np.full(T, _PAPER_CHIPS, np.int64),
                       duration=np.ones(T, np.int64),
                       load=np.full(T, float(demand)),
                       deferrable=np.zeros(T, bool))
    r = simulate_fleet(fleet, ci, np.arange(N), cfg, jobs=jobs,
                       record_matrices=True)
    return r.util, r.on
