"""Rolling multi-epoch fleet simulator: arrivals, departures, migration
(torch twin of ``repro.core.simulator``).

Each hourly epoch:

1. reads ``ci_now`` from per-region traces and, when the FCFP weight is
   on, fits the forecaster on the trailing ``history_h`` window;
2. releases finished jobs;
3. migrates the worst-placed running jobs when the policy's gain beats
   the checkpoint carbon (``migration_budget`` per epoch), and
   force-evicts jobs from outaged or flapping nodes.  The gain and the
   deferral decision come from ``SimConfig.policy``
   (``repro_torch.core.policy``): the reactive parity oracle, the
   green-window planner (a discounted look-ahead over the forecast) and
   SLO deferral (a deadline/value priority queue with deadline-miss
   accounting);
4. admits the seeded arrival stream (deferrable jobs may wait for a
   greener hour), placing every event through ONE lifecycle-engine call;
5. accounts emissions in f64 numpy on the host, per tenant too when
   ``n_tenants > 0``;
5b. with ``SimConfig.traffic``, routes the epoch's fleet requests across
   the placed serving replicas (``repro_torch.core.router``) and
   attributes their gCO2.  The router reads the post-placement job table
   and never feeds back, so every traffic-free result stays bitwise as it
   is.

``SimConfig.faults`` (``repro_torch.core.faults``) degrades every signal
the policies read — the observed CI trace, the forecast service, the
migration actuator, node health — while emissions and migration cost are
charged at the true CI.

Steps 1 and 4's placement run on the fleet's device (the rank kernel when
``use_kernel``); the job bookkeeping and the accounting are the
reference's numpy code, so the same placements give the same emissions.
``engine="blind"``/``"spread"`` are the carbon-blind comparators.
``paper_scenario_alloc`` is the paper experiment as the N=3 / T=8760
special case.

**Two drivers.**  ``simulate_fleet`` is the host loop: one placement-engine
call per epoch, Python job bookkeeping, f64 accounting — the oracle.
``simulate_fleet_scan`` keeps the whole job table on the device as a
fixed-capacity slot table with padded event buffers (``ScanPlan``) and
runs each epoch as masked tensor code around the batched placement engine
(``placement.place_lifecycle_batched``); ``simulate_fleet_ensemble`` runs
L such trajectories stacked on a leading lane axis, one engine call per
epoch for all lanes (the scan is its one-lane case), and
``sweep_policies`` drives a (policy x seed) grid through it.  Placements
and counters match the host loop exactly, emissions to f32 tolerance.

``shard=True`` splits the ensemble's lanes over the ranks of the default
process group (one process per rank).  Not ported yet (raises
``NotImplementedError``): ``shard="en"``'s node split over more than one
rank (ROADMAP Queue 1 slice (C)).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import forecast, telemetry
from repro_torch.core import policy as policylib
from repro_torch.core import router as routerlib
from repro_torch.core.energy import DEFAULT_ENERGY, EnergyModel
from repro_torch.core.faults import (FaultConfig, FaultPlan, fault_graph_key,
                                     plan_faults)
from repro_torch.core.fleet import Fleet, fleet_tensors
from repro_torch.core.placement import (HostSyncs, place_lifecycle_batched,
                                        place_lifecycle_full_rerank,
                                        place_lifecycle_shortlist)
from repro_torch.core.policy import Policy, PolicyConfig
from repro_torch.core.ranking import RankWeights
from repro_torch.core.traffic import (TrafficConfig, TrafficPlan,
                                      plan_traffic, traffic_graph_key,
                                      validate_qps_weights)

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
    # None = perfect signals; a FaultConfig degrades every signal the
    # policies read while emission accounting stays on ground truth
    faults: Optional[FaultConfig] = None
    # None = no serving layer; a TrafficConfig attaches a seeded fleet-QPS
    # stream that the router splits across the placed serving replicas
    # every epoch under ``policy.router_slo_s`` (step 5b).  Only
    # traffic_graph_key(traffic), the service count, shapes the scanned
    # trajectory; rates, SLO and greenness are per-lane data
    traffic: Optional[TrafficConfig] = None
    # --- migration ---
    migration_budget: int = 0       # max policy migrations / epoch
    migration_overhead_h: float = 0.05   # checkpoint+restore wall clock
    # --- power model ---
    energy: EnergyModel = DEFAULT_ENERGY
    power_off_idle: bool = True     # nodes with no jobs draw zero
    # > 0 draws a tenant id per job (after every other column) and splits
    # each on-node's gCO2 across its jobs by chips; the idle/rounding
    # remainder lands in bin n_tenants, so the bins sum to the total
    n_tenants: int = 0
    # manual override for the scanned core's job-table width (0 = the
    # sound ScanPlan bound); named by the slot-overflow error message
    scan_slots: int = 0
    # straggler bonus of powered-off nodes, so SCHEDULE_WEIGHT favours
    # consolidation onto already-on nodes; 0 disables
    consolidate: float = 1.0

    @property
    def use_forecast(self) -> bool:
        return self.weights.w2 != 0.0


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
    """Struct-of-arrays over jobs, sorted by arrival epoch.

    ``deadline``/``value`` are the SLO-deferral columns (start slack in
    epochs, queue-priority value); ``None`` means the policy layer derives
    the reactive defaults (``policy.Policy.for_jobs``).  ``tenant`` is the
    attribution column (``SimConfig.n_tenants``).  ``svc_class`` /
    ``qps_weight`` are the serving columns (the service a placed replica
    belongs to and its share of that service's QPS); ``None`` or
    ``svc_class < 0`` means the job serves no requests."""
    arrive: np.ndarray      # (J,) epoch of arrival
    chips: np.ndarray       # (J,) chip demand
    duration: np.ndarray    # (J,) epochs of runtime
    load: np.ndarray        # (J,) float dynamic load (util accounting)
    deferrable: np.ndarray  # (J,) bool
    deadline: Optional[np.ndarray] = None   # (J,) start slack in epochs
    value: Optional[np.ndarray] = None      # (J,) f32 job value
    tenant: Optional[np.ndarray] = None     # (J,) tenant id (attribution)
    qps_weight: Optional[np.ndarray] = None  # (J,) i32 QPS share weight
    svc_class: Optional[np.ndarray] = None   # (J,) i32 service; -1 = none

    @property
    def n(self) -> int:
        return self.arrive.shape[0]


def generate_jobs(cfg: SimConfig) -> JobSchedule:
    """Seeded stochastic arrival stream: Poisson with diurnal modulation and
    an optional flash crowd; geometric durations; uniform chip demands.
    The reference's numpy draws in the reference's order: the reactive
    columns, then the SLO columns, then the tenant ids, then the serving
    columns, so turning a later column on perturbs none of the earlier
    ones."""
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
    deadline = value = None
    if cfg.policy.deferral == "slo":
        lo = max(cfg.policy.deadline_lo, 1)
        hi = max(cfg.policy.deadline_hi
                 if cfg.policy.deadline_hi > 0 else cfg.defer_max_h, lo)
        deadline = rng.integers(lo, hi + 1, J)
        value = rng.exponential(1.0, J).astype(np.float32)
    tenant = None
    if cfg.n_tenants > 0:
        tenant = rng.integers(0, cfg.n_tenants, J).astype(np.int32)
    qps_weight = svc_class = None
    if traffic_graph_key(cfg.traffic) > 0:
        tc = cfg.traffic
        serving = rng.random(J) < tc.serve_frac
        svc_class = np.where(serving, rng.integers(0, tc.n_svc, J),
                             -1).astype(np.int32)
        qps_weight = np.where(serving, rng.integers(1, tc.weight_hi + 1, J),
                              0).astype(np.int32)
    return JobSchedule(arrive=arrive, chips=chips.astype(np.int64),
                       duration=duration.astype(np.int64),
                       load=chips.astype(np.float64),
                       deferrable=deferrable, deadline=deadline,
                       value=value, tenant=tenant,
                       qps_weight=qps_weight, svc_class=svc_class)


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
    migrations_failed: int = 0      # actuation failures (budget consumed)
    jobs_active_end: int = 0        # still running when the horizon ends
    safe_epochs: int = 0            # epochs spent with policy frozen
    start_epoch: Optional[np.ndarray] = None  # (J,) first-placement epoch
    util: Optional[np.ndarray] = None   # (N, T) when record_matrices
    on: Optional[np.ndarray] = None
    # (n_tenants + 1,) gCO2 per tenant when cfg.n_tenants > 0; the last
    # bin is the unattributed idle/overhead remainder; the bins sum to
    # emissions_g
    tenant_emissions_g: Optional[np.ndarray] = None
    # --- request-serving layer (SimConfig.traffic; see core.router) ---
    req_served: int = 0             # requests routed onto replicas
    req_offered: int = 0            # requests offered to active services
    # request-attributed gCO2: a slice of the node energy already counted
    # in emissions_g, not added to it
    req_gco2: float = 0.0
    p99_violations: int = 0         # replica-epochs routed above lambda_max
    req_p99_s: float = 0.0          # request-weighted modeled p99 (s)
    # (n_tenants + 1,) request gCO2 per tenant (the spare last bin stays
    # 0); the bins sum to req_gco2
    tenant_request_g: Optional[np.ndarray] = None
    # device reads the scanned driver waited for (its whole bucket's, each
    # a loop test of the batched placement engine); 0 for the host loop
    host_syncs: int = 0


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
                flops_per_j, t, cap, healthy, demands, nodes, statics, fc,
                energy=None):
    """One simulator epoch on the device: slice the (observed) CI column,
    build the Fleet and run the lifecycle placement engine.  ``fc`` is the
    epoch's ``_forecast_step`` (None when the forecast is not an input);
    ``straggler`` already carries the per-epoch consolidation bonus.
    Returns (node, capacity, n_sweeps, ci_now, cur_rate, fut_rate)."""
    ci_now = traces[:, t][ridx]
    if fc is not None:
        ci_fc, fut_rate = fc[0][ridx], fc[1]
    else:
        ci_fc = ci_now
        fut_rate = torch.tensor(torch.inf, device=traces.device)
    node, cap_out, n_sweeps = _place_epoch(
        pue, power_kw, chips_total, straggler, flops_per_j, ci_now, ci_fc,
        cap, cap, healthy, demands, nodes, statics, energy=energy)
    cur_rate = torch.where(healthy, ci_now * pue, torch.inf).min()
    return node, cap_out, n_sweeps, ci_now, cur_rate, fut_rate


def _forecast_step(traces, region_pue, a: int, history_h: int,
                   horizon_h: int, defer_window: int, fc_ok: bool = True,
                   lookahead: Optional[Tuple[int, float]] = None):
    """The forecast inputs of the epoch that reads trace column ``a``:
    (per-region mean FCFP forecast (R,), the greenest CFP rate inside the
    deferral window), plus, with ``lookahead = (lookahead_h, discount)``,
    the green-window planner's (la_ci (R,), la_dst, gw_min).  One fit per
    epoch window in both drivers, so the scanned core's hoisted forecast
    is the host loop's, bit for bit.  ``fc_ok = False`` is a
    forecast-service outage: the persistence-of-day forecast over the same
    (observed) window stands in for the fit."""
    window = traces[:, a - history_h:a]
    if fc_ok:
        fc, _ = forecast.forecast_regions(window, horizon_h, 0)  # (R, H)
    else:
        fc = forecast.persistence_regions(window, horizon_h)
    # node-less regions are masked (a clamped 0.0 forecast times +inf is
    # NaN)
    rp_ok = torch.isfinite(region_pue)
    fut_rate = torch.where(rp_ok[:, None],
                           fc[:, :defer_window] * region_pue[:, None],
                           torch.inf).min()
    out = (torch.mean(fc, dim=-1), fut_rate)
    if lookahead is not None:
        la_ci, gw_min = forecast.green_window_signals(fc, region_pue,
                                                      *lookahead)
        la_dst = torch.where(rp_ok, la_ci * region_pue, torch.inf).min()
        out += (la_ci, la_dst, gw_min)
    return out


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


def _fault_plan(cfg: SimConfig, region_ci: np.ndarray, ridx: np.ndarray,
                n_nodes: int) -> Optional[FaultPlan]:
    """The run's materialized fault streams (None without faults)."""
    if cfg.faults is None:
        return None
    return plan_faults(cfg.faults, np.asarray(region_ci, np.float64),
                       np.asarray(ridx), cfg.epochs, cfg.history_h,
                       cfg.migration_budget, n_nodes, cfg.seed)


def _tenant_column(cfg: SimConfig, jobs: JobSchedule) -> Optional[np.ndarray]:
    if not cfg.n_tenants:
        return None
    if jobs.tenant is None:
        raise ValueError("cfg.n_tenants > 0 requires jobs.tenant "
                         "(generate_jobs draws it when n_tenants is set)")
    return np.asarray(jobs.tenant, np.int64)


def _traffic_plan(cfg: SimConfig, jobs: JobSchedule
                  ) -> Optional[TrafficPlan]:
    """The run's materialized request stream (None without serving),
    after checking the schedule's serving columns."""
    if traffic_graph_key(cfg.traffic) == 0:
        return None
    validate_qps_weights(jobs.qps_weight)
    if jobs.svc_class is None:
        raise ValueError("SimConfig.traffic requires a JobSchedule "
                         "svc_class column (generate_jobs draws it when "
                         "cfg.traffic is set)")
    return plan_traffic(cfg.traffic, cfg.epochs, cfg.seed)


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
    slo = pol.slo
    q_cap = pol.queue_cap(T) if slo else 0
    use_fc = cfg.use_forecast and not blind
    planner = (pol.lookahead and cfg.migration_budget > 0 and use_fc)
    green_factor = float(cfg.policy.defer_green_factor)
    outs = _outage_windows(cfg.outage)
    dev = fleet0.device

    region_ci = np.asarray(region_ci)
    ridx = np.asarray(ridx)
    # fault streams: every policy decision reads the degraded OBSERVED
    # trace (the device epoch step included); emission and migration-cost
    # accounting stays on the true trace
    fplan = _fault_plan(cfg, region_ci, ridx, N)
    obs_ci = region_ci if fplan is None else fplan.obs_traces
    has_flaps = fplan is not None and fplan.has_flaps
    mig_block: Dict[int, Tuple[int, int]] = {}  # job -> (until, n_fails)
    mig_failed = 0
    traces = torch.from_numpy(np.asarray(obs_ci).astype(np.float32)).to(dev)
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
    slo_queue: list = []                   # SLO priority queue (sorted)

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
               cfg.horizon_h, cfg.history_h, use_fc,
               pol.defer_window(cfg.defer_max_h))
    lookahead = (cfg.policy.lookahead_h, cfg.policy.discount) \
        if planner else None
    overhead_s = cfg.migration_overhead_h * 3600.0
    ten = _tenant_column(cfg, jobs)
    n_ten = int(cfg.n_tenants)
    tenant_g = np.zeros(n_ten + 1) if n_ten else None

    # request-serving traffic: the router reads the job table after the
    # epoch's placements settle (step 5b) and never feeds back, so every
    # traffic-free result stays bitwise as it is
    tplan = _traffic_plan(cfg, jobs)
    n_svc = traffic_graph_key(cfg.traffic)
    req_served = req_offered = req_viol = 0
    req_g = p99_wsum = 0.0
    ten_req = None
    if n_svc > 0:
        tcfg = cfg.traffic
        svc_col = np.asarray(jobs.svc_class, np.int32)
        w_col = np.asarray(jobs.qps_weight, np.int32)
        c_max_r = int(np.max(jobs.chips, initial=1))
        # per-replica admissible rate: the M/M/c inversion runs once here
        # in f64; every driver gathers from the same int32 table
        lam_cap = routerlib.lambda_caps(c_max_r, tcfg.mu_per_chip,
                                        cfg.policy.router_slo_s)
        pue32 = fleet0.pue.cpu().numpy().astype(np.float32)
        green32 = np.float32(cfg.policy.router_greenness)
        req_kwh = float(em_host.req_kwh(1.0 / tcfg.mu_per_chip))
        ten_req = np.zeros(n_ten + 1) if n_ten else None

    def epoch_step(a, dem, tgt):
        return _epoch_core(
            traces, ridx_d, fleet0.pue, fleet0.power_kw, fleet0.chips_total,
            strag, fleet0.flops_per_j, a, cap, healthy_d, dem, tgt, statics,
            fc_t, em_dev)

    for t in range(T):
        a = cfg.history_h + t
        ci_col = region_ci[:, a][ridx]      # (N,) f64 TRUE (accounting)
        ci_obs_col = obs_ci[:, a][ridx]     # (N,) f64 observed (policy)
        fc_ok_t = bool(fplan.fc_ok[t]) if fplan is not None else True
        safe_t = bool(fplan.safe[t]) if fplan is not None else False
        healthy = healthy0.copy()
        for reg, t0, length in outs:
            if t0 <= t < t0 + length:
                healthy &= (ridx != reg)
        if has_flaps:
            healthy &= fplan.eligible[t]
        # the epoch's forecast (and planner signals), fitted once on the
        # observed window; the placement and its redo call share it
        fc_t = _forecast_step(traces, region_pue_d, a, cfg.history_h,
                              cfg.horizon_h, statics[7], fc_ok_t,
                              lookahead) if use_fc else None

        # ---- 1. end-of-life releases --------------------------------
        rel_jobs = [j for j in ends.pop(t, []) if jstate[j] == _ACTIVE]
        for j in rel_jobs:
            jstate[j] = _DONE
            completed += 1
            njobs[jnode[j]] -= 1
            load_on[jnode[j]] -= jobs.load[j]

        # ---- 2. forced evictions + migration policy -----------------
        active = np.where(jstate == _ACTIVE)[0]
        evict = active[~healthy[jnode[active]]] if (outs or has_flaps) \
            else np.empty(0, np.int64)
        mig: list = []
        if cfg.migration_budget > 0 and not blind and active.size:
            stay = active[healthy[jnode[active]]]
            free = cap_h.copy()
            # policy rates read the OBSERVED trace; the move is charged at
            # the true CI below
            rate = np.where(healthy, pue_h * ci_obs_col, np.inf)
            # best achievable CFP rate per distinct chip demand, O(C·N)
            best_rate: Dict[int, float] = {}
            for c in np.unique(jobs.chips[stay]):
                feas = rate[free >= c]
                best_rate[int(c)] = float(feas.min()) if feas.size else np.inf
            chips_arr = jobs.chips[stay]
            br_arr = np.array([best_rate[int(c)] for c in chips_arr]) \
                if stay.size else np.empty(0)
            la_kw = {}
            if planner:
                la = torch.cat([fc_t[2], fc_t[3][None], fc_t[4][None]]
                               ).cpu().numpy()
                la_node = la[:-2][ridx] * pue_h            # (N,) f64
                la_kw = dict(src_la=la_node[jnode[stay]],
                             dst_la=float(la[-2]), gw_min=float(la[-1]))
            gain = policylib.migration_gain(
                np, cfg.policy,
                rate_cur=rate[jnode[stay]], best_rate=br_arr,
                chips=chips_arr,
                remaining=np.maximum(jend[stay] - t, 0),
                e_kwh_h=float(em_host.e_kwh_h),
                ckpt=np.asarray(em_host.job_energy_kwh(overhead_s, 1,
                                                       chips_arr)),
                **la_kw)
            if mig_block and stay.size:
                # retry with backoff: a job whose last actuation failed
                # sits out the candidate sort until its backoff ends
                blocked = np.array([mig_block.get(int(j), (0, 0))[0] > t
                                    for j in stay])
                gain = np.where(blocked, -np.inf, gain)
            if safe_t:
                gain = policylib.degraded_gain(np, gain, safe_t)
            order = np.argsort(-gain, kind="stable")
            # attempt rank k draws fault stream mig_fail[t, k]: a failed
            # command uses up its budget slot (the job stays put, nothing
            # charged) and doubles the job's retry backoff
            for k, i in enumerate(order[:cfg.migration_budget]):
                if not gain[i] > 0.0:
                    continue
                j = int(stay[i])
                if fplan is not None and k < fplan.mig_fail.shape[1] \
                        and fplan.mig_fail[t, k]:
                    nf = mig_block.get(j, (0, 0))[1] + 1
                    mig_block[j] = (t + cfg.faults.mig_backoff_h
                                    * (1 << min(nf - 1, 10)), nf)
                    mig_failed += 1
                    continue
                mig.append(j)
                mig_block.pop(j, None)
        migrations += len(mig)
        evictions += evict.size
        movers = list(evict) + mig
        for j in movers:
            njobs[jnode[j]] -= 1
            load_on[jnode[j]] -= jobs.load[j]
            if j in mig:
                mc = (float(em_host.job_energy_kwh(overhead_s, 1,
                                                   int(jobs.chips[j])))
                      * pue_h[jnode[j]] * ci_col[jnode[j]])
                mig_cost_total += mc
                if n_ten:       # the overhead belongs to the mover's tenant
                    tenant_g[ten[j]] += mc

        # ---- 3. new arrivals (+ deferral policy) --------------------
        arr_jobs = (slo_queue if slo else deferred.pop(t, [])) \
            + by_arrival.pop(t, [])
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
            # safe mode: a stale fleet stops chasing green hours it can no
            # longer see — the inf future rate turns every wants_defer off
            fut_rate = float(policylib.degraded_future(np, fut_rate,
                                                       safe_t))

        # ---- 4. record outcomes -------------------------------------
        # deferrable jobs whose green hour is coming release their slot
        # again (re-run next epoch); done post-hoc so the event stream
        # stays identical across engines
        green_later = bool(policylib.wants_defer(fut_rate, cur_rate,
                                                 green_factor))
        keepset: set = set()
        if slo:
            # SLO deferral: queued and new jobs that want to wait compete
            # for the fixed-capacity priority queue (value asc, deadline
            # desc, job id); overflow and deadline-reached jobs place now.
            # The per-job green test runs in float32, as the scan's does
            cur32, fut32 = np.float32(cur_rate), np.float32(fut_rate)
            cand = []
            for i, j in enumerate(arr_jobs):
                if pol.slack[j] > 0 \
                        and (t - int(jobs.arrive[j])) < int(pol.slack[j]):
                    node = int(out[arr_off + i])
                    if node < 0 or bool(policylib.wants_defer(
                            fut32, cur32, pol.thresh[j])):
                        cand.append(j)
            slo_queue = []
            if cand:
                cj = np.asarray(cand, np.int64)
                order = policylib.slo_queue_order(pol.value[cj],
                                                  pol.deadline_ep[cj], cj)
                slo_queue = [int(cj[k]) for k in order[:q_cap]]
            keepset = set(slo_queue)
        redo_d, redo_n = [], []
        for i, j in enumerate(movers + arr_jobs):
            node = int(out[arr_off - len(movers) + i]) if i < len(movers) \
                else int(out[arr_off + (i - len(movers))])
            is_new = i >= len(movers)
            if is_new:
                if slo:
                    defer_now = j in keepset
                else:
                    defer_now = bool(jobs.deferrable[j]) \
                        and (t - int(jobs.arrive[j])) < cfg.defer_max_h \
                        and (green_later if node >= 0 else True)
                if defer_now:
                    if node >= 0:
                        # take the placement back: defer to next epoch
                        redo_d.append(-int(jobs.chips[j]))
                        redo_n.append(node)
                    if not slo:
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

        # ---- 5. emission accounting (at the TRUE CI) ----------------
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
        if n_ten:
            # each on-node's gCO2 split across its resident jobs by chips;
            # the idle/rounding remainder goes to the last bin, so the bins
            # sum to series[t]
            act = np.where(jstate == _ACTIVE)[0]
            occ_chips = np.zeros(N)
            np.add.at(occ_chips, jnode[act], jobs.chips[act])
            share = node_g / np.maximum(occ_chips, 1.0)
            contrib = share[jnode[act]] * jobs.chips[act]
            np.add.at(tenant_g, ten[act], contrib)
            tenant_g[-1] += series[t] - float(contrib.sum())
        if record_matrices:
            util_m[:, t] = load_on
            on_m[:, t] = on.astype(np.float64)

        # ---- 5b. request routing + serving attribution --------------
        # lanes are the epoch's post-placement active jobs in job-id
        # order; the routing DECISION reads the observed CI column (f32,
        # as the scanned driver does), the ATTRIBUTION the true one (f64)
        if n_svc > 0:
            act_r = np.where(jstate == _ACTIVE)[0]
            jn = jnode[act_r]
            ci_r32 = np.asarray(obs_ci[:, a], np.float32)
            carbon = pue32[jn] * ci_r32[ridx[jn]]
            chips_l = np.asarray(jobs.chips[act_r], np.int64)
            cap_l = lam_cap[np.minimum(chips_l, c_max_r)]
            routed, offered = routerlib.route_epoch(
                np, req_t=np.int32(tplan.req[t]), svc=svc_col[act_r],
                jid=act_r.astype(np.int32), weight=w_col[act_r],
                cap=cap_l, carbon=carbon, n_svc=n_svc, greenness=green32)
            req_served += int(routed.sum())
            req_offered += int(offered[:n_svc].sum())
            req_viol += int(((routed > cap_l)
                             & (svc_col[act_r] >= 0)).sum())
            g_lane = routed.astype(np.float64) * (
                req_kwh * pue_h[jn] * ci_col[jn])
            req_g += float(g_lane.sum())
            p99_l = routerlib.modeled_p99(np, routed, chips_l, c_max_r,
                                          tcfg.mu_per_chip)
            p99_wsum += float((routed.astype(np.float64) * p99_l).sum())
            if n_ten:
                np.add.at(ten_req, ten[act_r], g_lane)

    # jobs still waiting in a deferral queue when the horizon ends were
    # never run: account them as dropped and as deadline misses (every
    # queued job has slack > 0)
    for pending in list(deferred.values()) + [slo_queue]:
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
                     defer_delay_h=delay_h, migrations_failed=mig_failed,
                     jobs_active_end=int((jstate == _ACTIVE).sum()),
                     safe_epochs=int(fplan.safe.sum())
                     if fplan is not None else 0,
                     start_epoch=jstart, util=util_m, on=on_m,
                     tenant_emissions_g=tenant_g,
                     req_served=req_served, req_offered=req_offered,
                     req_gco2=req_g, p99_violations=req_viol,
                     req_p99_s=p99_wsum / max(req_served, 1),
                     tenant_request_g=ten_req)


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
# the scanned trajectory: a fixed-slot job table and padded event buffers,
# every tensor carrying a leading lane axis (L = 1 for simulate_fleet_scan)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """Static shapes of the scanned core, derived from the job schedule.

    Every per-epoch buffer is padded to a sound upper bound computed on
    the host:

    - ``slots``: job-table size — interval bound on concurrently active
      jobs (a job can hold chips only during ``[arrive, arrive +
      defer_slack + duration)``);
    - ``a_max`` / ``rel_cap`` / ``d_cap``: most new arrivals, end-of-life
      releases and carried deferrals in any epoch (under SLO deferral
      ``d_cap`` is the priority queue's capacity, ``Policy.queue_cap``);
    - ``m_evict``: eviction buffer — ``slots`` with outage windows or node
      flapping, else 0.

    The core still counts any bound violation in ``overflow`` (a nonzero
    value is an internal error, raised after the run)."""
    slots: int
    a_max: int
    d_cap: int
    rel_cap: int
    m_evict: int
    arr_ids: np.ndarray     # (T, a_max) job ids arriving per epoch, -1 pad


def _scan_plan(cfg: SimConfig, jobs: JobSchedule, pol: Policy,
               pad: bool = False) -> ScanPlan:
    """The scanned core's static shapes (the reference's ``_scan_plan``).
    ``pad`` rounds every buffer up to ``_pad_bucket`` sizes — pads are
    exact no-ops, and seed ensembles with slightly different schedules
    then share one bucket."""
    T = cfg.epochs
    arrive = np.asarray(jobs.arrive, np.int64)
    dur = np.asarray(jobs.duration, np.int64)
    slack = pol.slack
    in_h = arrive < T           # jobs arriving past the horizon never run
    counts = np.bincount(arrive[in_h], minlength=T) if arrive.size else \
        np.zeros(T, np.int64)
    a_max = max(int(counts.max(initial=0)), 1)
    if pad:
        a_max = _pad_bucket(a_max)
    arr_ids = np.full((T, a_max), -1, np.int32)
    if arrive.size:
        # the host loop's by_arrival order: ascending job id per epoch
        order = np.argsort(arrive, kind="stable")
        order = order[arrive[order] < T]
        ofs = np.concatenate([[0], np.cumsum(counts)])
        pos = np.arange(order.size) - ofs[arrive[order]]
        arr_ids[arrive[order], pos] = order
    hi = T + int((dur + slack).max(initial=0)) + 2
    diff = np.zeros(hi, np.int64)
    np.add.at(diff, arrive[in_h], 1)
    np.add.at(diff, (arrive + slack + dur)[in_h], -1)
    slots = max(int(np.cumsum(diff).max(initial=0)), a_max, 1,
                int(cfg.scan_slots))
    # the end-of-life release epoch lies in [arrive + dur, ... + slack]
    rdiff = np.zeros(hi, np.int64)
    np.add.at(rdiff, np.minimum((arrive + dur)[in_h], hi - 1), 1)
    np.add.at(rdiff, np.minimum((arrive + dur + slack)[in_h] + 1, hi - 1),
              -1)
    rel_cap = max(int(np.cumsum(rdiff)[:T].max(initial=0)), 1)
    if pol.slo:
        # SLO: the carry IS the fixed-capacity priority queue
        d_cap = pol.queue_cap(T) if bool((slack[in_h] > 0).any()) else 0
    else:
        d_cap = policylib.sound_queue_bound(arrive, slack, T)
    if pad:
        slots = _pad_bucket(slots)
        rel_cap = _pad_bucket(rel_cap)
        if d_cap > 0 and not pol.slo:   # the SLO queue cap is semantic
            d_cap = _pad_bucket(d_cap)
    # flapping nodes force evictions as outage windows do
    flaps = cfg.faults is not None and cfg.faults.flap_rate > 0.0
    m_evict = slots if (_outage_windows(cfg.outage) or flaps) else 0
    return ScanPlan(slots=slots, a_max=a_max, d_cap=d_cap, rel_cap=rel_cap,
                    m_evict=m_evict, arr_ids=arr_ids)


@dataclasses.dataclass(frozen=True)
class _Dims:
    """The buffer sizes and trajectory-shaping config one bucket shares
    (the reference's ``dims`` tuple, by name)."""
    epochs: int
    slots: int
    a_max: int
    d_cap: int
    rel_cap: int
    m_evict: int
    budget: int
    chips_max: int
    history_h: int
    defer_max_h: int
    outage: tuple
    power_off_idle: bool
    consolidate: float
    policy: PolicyConfig
    n_ten: int              # tenant bins - 1 (0 = no attribution)
    faults: tuple           # faults.fault_graph_key
    n_svc: int              # traffic_graph_key (0 = no serving layer)

    @property
    def planner(self) -> bool:
        """The green-window planner runs (given a forecast): it needs a
        migration budget and a job table to migrate from."""
        return (self.policy.migration == "lookahead"
                and min(self.budget, self.slots) > 0)


@dataclasses.dataclass
class _ScanRun:
    """One prepared trajectory: schedule-derived plan + static key, ready
    to be built into scan inputs alone or stacked into a bucket."""
    fleet0: Fleet
    region_ci: np.ndarray
    ridx: np.ndarray
    cfg: SimConfig
    jobs: JobSchedule
    pol: Policy
    plan: ScanPlan
    statics: tuple
    mig_nmax: int           # widest region (columns of the mig_perm table)
    fplan: Optional[FaultPlan] = None   # materialized fault streams
    tplan: Optional[TrafficPlan] = None  # materialized request stream


def _prepare_scan_run(fleet0: Fleet, region_ci: np.ndarray,
                      ridx: np.ndarray, cfg: SimConfig,
                      jobs: Optional[JobSchedule] = None,
                      pad_plan: bool = False) -> _ScanRun:
    if cfg.engine not in ("shortlist", "full"):
        raise ValueError(
            f"scanned core supports engine='shortlist'|'full', got "
            f"{cfg.engine!r} (blind/spread comparators are host-only)")
    jobs = jobs if jobs is not None else generate_jobs(cfg)
    _tenant_column(cfg, jobs)       # raises when the tenant ids are missing
    pol = Policy.for_jobs(cfg.policy, jobs.arrive, jobs.deferrable,
                          cfg.defer_max_h, jobs.deadline, jobs.value)
    plan = _scan_plan(cfg, jobs, pol, pad=pad_plan)
    statics = (cfg.engine, cfg.shortlist, cfg.use_kernel,
               cfg.weights.graph_key(), cfg.horizon_h, cfg.history_h,
               cfg.use_forecast, pol.defer_window(cfg.defer_max_h))
    sizes = np.bincount(np.asarray(ridx, np.int64),
                        minlength=region_ci.shape[0])
    return _ScanRun(fleet0=fleet0, region_ci=np.asarray(region_ci),
                    ridx=np.asarray(ridx), cfg=cfg, jobs=jobs, pol=pol,
                    plan=plan, statics=statics,
                    mig_nmax=max(int(sizes.max(initial=0)), 1),
                    fplan=_fault_plan(cfg, region_ci, ridx, fleet0.n),
                    tplan=_traffic_plan(cfg, jobs))


def _bucket_key(run: _ScanRun) -> tuple:
    """Everything that must match for two runs to share one batched
    trajectory; the buffer sizes are maxed over the bucket instead."""
    cfg = run.cfg
    return (run.statics, cfg.epochs, run.fleet0.n, run.region_ci.shape,
            cfg.migration_budget, cfg.defer_max_h,
            _outage_windows(cfg.outage), cfg.power_off_idle,
            float(cfg.consolidate), cfg.policy.graph_key(),
            cfg.n_tenants > 0, fault_graph_key(cfg.faults),
            traffic_graph_key(cfg.traffic), str(run.fleet0.device))


def _shared_dims(runs, pad: bool):
    """A bucket's shared ``_Dims``: every buffer size is the member-wise
    maximum (padding is an exact no-op for each member, by ``ScanPlan``'s
    own soundness argument).  Returns ``(dims, Jp, mig_nmax)``."""
    cfg = runs[0].cfg
    slots = max(r.plan.slots for r in runs)
    outs = _outage_windows(cfg.outage)
    fkey = fault_graph_key(cfg.faults)
    dims = _Dims(
        epochs=cfg.epochs, slots=slots,
        a_max=max(r.plan.a_max for r in runs),
        d_cap=max(r.plan.d_cap for r in runs),
        rel_cap=max(r.plan.rel_cap for r in runs),
        m_evict=slots if (outs or fkey[2]) else 0,
        budget=cfg.migration_budget,
        chips_max=max(int(np.max(r.jobs.chips, initial=1)) for r in runs),
        history_h=cfg.history_h, defer_max_h=cfg.defer_max_h, outage=outs,
        power_off_idle=cfg.power_off_idle,
        consolidate=float(cfg.consolidate), policy=cfg.policy.graph_key(),
        n_ten=max(r.cfg.n_tenants for r in runs), faults=fkey,
        n_svc=traffic_graph_key(cfg.traffic))
    jp = max((_pad_bucket(max(r.jobs.n, 1)) if pad else max(r.jobs.n, 1))
             for r in runs)
    return dims, jp, max(r.mig_nmax for r in runs)


def _build_arrs(run: _ScanRun, dims: _Dims, jp: int, mig_nmax: int,
                fc_cache: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Device inputs of ONE trajectory at the bucket's shared shapes.

    Padding conventions (exact no-ops): padded jobs arrive past the
    horizon; padded ``arr_ids`` hold -1; padded ``mig_perm`` columns hold
    the node count N with +inf pue.  The forecast (and the planner's
    signals) is fitted here for every epoch window, with the host loop's
    own per-epoch call (``_forecast_step``); ``fc_cache`` shares the fits
    between runs of one fleet and observed trace set.  Under faults the
    decisions read the observed trace (``traces``) and the accounting the
    true one (``traces_true``); the fault streams are uploaded here, once
    per run."""
    fleet0, cfg, jobs, plan = run.fleet0, run.cfg, run.jobs, run.plan
    region_ci, ridx = run.region_ci, run.ridx
    N, T, J = fleet0.n, cfg.epochs, jobs.n
    dev = fleet0.device

    def jconst(x, fill, dtype):
        out = np.full(jp, fill, dtype)
        out[:J] = np.asarray(x, dtype)[:J]
        return torch.from_numpy(out).to(dev)

    R = region_ci.shape[0]
    ridx_np = np.asarray(ridx, np.int64)
    pue_np = fleet0.pue.cpu().numpy()
    # per-region pue-ascending node order for the migration policy's best
    # feasible rate (rate = pue · ci_region: within a region the order of
    # the rates never changes)
    sizes = np.bincount(ridx_np, minlength=R)
    mig_perm = np.full((R, mig_nmax), N, np.int64)
    mig_pue = np.full((R, mig_nmax), np.inf, np.float32)
    order = np.lexsort((pue_np, ridx_np))
    col = np.arange(order.size) \
        - np.concatenate([[0], np.cumsum(sizes)])[ridx_np[order]]
    mig_perm[ridx_np[order], col] = order
    mig_pue[ridx_np[order], col] = pue_np[order]
    arr_ids = np.full((T, dims.a_max), -1, np.int64)
    arr_ids[:, :plan.a_max] = plan.arr_ids
    fp = run.fplan
    obs_ci = region_ci if fp is None else fp.obs_traces
    traces = torch.from_numpy(np.asarray(obs_ci).astype(np.float32)).to(dev)
    region_pue = torch.from_numpy(_region_pue(
        R, ridx_np, pue_np.astype(np.float64)).astype(np.float32)).to(dev)

    def f32(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    em = cfg.energy
    arrs = dict(
        mig_perm=torch.from_numpy(mig_perm).to(dev),
        mig_pue=torch.from_numpy(mig_pue).to(dev),
        traces=traces, ridx=torch.from_numpy(ridx_np).to(dev),
        pue=fleet0.pue, power_kw=fleet0.power_kw,
        chips_total=fleet0.chips_total, flops_per_j=fleet0.flops_per_j,
        straggler=fleet0.straggler_score, healthy=fleet0.healthy,
        capacity=fleet0.capacity.to(torch.int32),
        chips=jconst(jobs.chips, 0, np.int64),
        duration=jconst(jobs.duration, 1, np.int64),
        arrive=jconst(jobs.arrive, T + 1, np.int64),
        deferrable=jconst(jobs.deferrable, False, bool),
        arr_ids=torch.from_numpy(arr_ids).to(dev),
        green_factor=f32(cfg.policy.defer_green_factor),
        green_gate=f32(cfg.policy.green_gate),
        # the EnergyModel as f32 scalars (the host loop's em_dev values)
        en_idle=f32(em.idle_frac), en_dyn=f32(em.dyn_frac),
        en_chipw=f32(em.chip_power_w), en_hostw=f32(em.host_power_w),
        en_embodied=f32(em.embodied_g_per_node_h),
        en_wmarg=f32(cfg.weights.marginal), en_ekwh=f32(em.e_kwh_h),
        en_ckpt=f32(em.ckpt_kwh(cfg.migration_overhead_h)))
    if dims.n_ten > 0:
        ten = jobs.tenant if jobs.tenant is not None \
            else np.zeros(J, np.int64)
        arrs["tenant"] = jconst(ten, 0, np.int64)
    if run.pol.slo:
        arrs.update(
            slack=jconst(run.pol.slack, 0, np.int64),
            thresh=jconst(run.pol.thresh, 1.0, np.float32),
            value=jconst(run.pol.value, np.inf, np.float32),
            deadline=jconst(run.pol.deadline_ep, 0, np.int64),
            q_cap=torch.tensor(plan.d_cap, dtype=torch.int64, device=dev))
    if fp is not None:
        # every fault stream is data: only fault_graph_key decides which
        # of them exist, so a dropout/staleness grid shares one bucket
        arrs.update(
            traces_true=torch.from_numpy(
                region_ci.astype(np.float32)).to(dev),
            f_safe=torch.from_numpy(fp.safe).to(dev),
            mig_backoff=torch.tensor(int(cfg.faults.mig_backoff_h),
                                     dtype=torch.int64, device=dev))
        if dims.faults[1]:
            arrs["f_mig_fail"] = torch.from_numpy(fp.mig_fail).to(dev)
        if dims.faults[2]:
            arrs["f_elig"] = torch.from_numpy(fp.eligible).to(dev)
    if dims.n_svc > 0:
        # serving: the request stream and the host-built M/M/c capacity
        # table (the bucket's chips_max; each entry bisected on its own,
        # so its prefix is the host loop's table) as integer data, the
        # SLO/greenness knobs per lane, so a (SLO x greenness) grid is one
        # bucket
        tc = cfg.traffic
        arrs.update(
            tr_req=torch.from_numpy(run.tplan.req).to(dev),
            svc=jconst(jobs.svc_class, -1, np.int64),
            qweight=jconst(jobs.qps_weight, 0, np.int64),
            lam_cap=torch.from_numpy(routerlib.lambda_caps(
                dims.chips_max, tc.mu_per_chip,
                cfg.policy.router_slo_s)).to(dev),
            greenness=f32(cfg.policy.router_greenness),
            tr_mu=f32(tc.mu_per_chip),
            en_reqkwh=f32(em.req_kwh(1.0 / tc.mu_per_chip)))
    if cfg.use_forecast:
        key = (id(region_ci), id(fleet0))
        if fp is not None:
            key += (cfg.faults, cfg.seed)
        if fc_cache is None or key not in fc_cache:
            horizon_h, history_h, defer_window = (run.statics[4],
                                                  run.statics[5],
                                                  run.statics[7])
            lookahead = (dims.policy.lookahead_h, dims.policy.discount) \
                if dims.planner else None
            steps = [_forecast_step(
                traces, region_pue, history_h + t, history_h, horizon_h,
                defer_window, bool(fp.fc_ok[t]) if fp is not None else True,
                lookahead) for t in range(T)]
            # (T, R) mean forecast, (T,) fut [, (T, R) la_ci, (T,) la_dst,
            # (T,) gw_min]
            fc = tuple(torch.stack(col) for col in zip(*steps))
            if fc_cache is not None:
                fc_cache[key] = fc
        else:
            fc = fc_cache[key]
        arrs["ci_fc_r"], fut = fc[:2]
        # safe mode: no green window while the signal is stale
        arrs["fut"] = fut if fp is None else policylib.degraded_future(
            torch, fut, arrs["f_safe"])
        if len(fc) > 2:
            arrs["la_ci"], arrs["la_dst"], arrs["gw_min"] = fc[2:]
    return arrs


def _take(arr, idx, valid, fill):
    """Per-lane masked gather ``arr[l, idx[l, j]]`` that never reads an
    out-of-range index (clamped, then masked)."""
    v = arr.gather(1, idx.clamp(0, arr.shape[1] - 1))
    return torch.where(valid, v, fill)


def _nonzero_sized(mask: torch.Tensor, size: int, fill: int
                   ) -> torch.Tensor:
    """Per lane, the positions of ``mask``'s True entries in ascending
    order, cut or padded with ``fill`` to ``size`` — ``jnp.nonzero(mask,
    size=size, fill_value=fill)`` by a cumsum scatter (unique targets; the
    discarded column ``size`` takes the rest)."""
    L, M = mask.shape
    rank = mask.cumsum(1) - 1
    tgt = torch.where(mask & (rank < size), rank, size)
    out = torch.full((L, size + 1), fill, dtype=torch.int64,
                     device=mask.device)
    out.scatter_(1, tgt, torch.arange(M, device=mask.device).expand(L, M))
    return out[:, :size]


def _scatter_drop(buf: torch.Tensor, idx: torch.Tensor, src, *,
                  add: bool) -> torch.Tensor:
    """``buf.at[l, idx].set/add(src, mode="drop")``: index ``buf.shape[1]``
    is the drop sentinel (a spare column, sliced off).  ``set`` targets
    are unique apart from the sentinel; ``add`` is integer or exact."""
    L, W = buf.shape
    ext = torch.cat([buf, buf.new_zeros((L, 1))], dim=1)
    src = torch.as_tensor(src, dtype=buf.dtype, device=buf.device
                          ).expand(idx.shape)
    if add:
        ext.scatter_add_(1, idx, src)
    else:
        ext.scatter_(1, idx, src)
    return ext[:, :W]


def _lane_energy(arrs, l: int) -> EnergyModel:
    """Lane ``l``'s EnergyModel as f32 0-d tensors (``EnergyModel.device``
    of the run's model, which the host loop hands its engine)."""
    return EnergyModel(
        idle_frac=arrs["en_idle"][l], chip_power_w=arrs["en_chipw"][l],
        host_power_w=arrs["en_hostw"][l],
        embodied_g_per_node_h=arrs["en_embodied"][l],
        w_marginal=arrs["en_wmarg"][l], dyn_frac=arrs["en_dyn"][l])


def _trajectory(arrs, statics, dims: _Dims, syncs: HostSyncs):
    """The whole trajectory of L stacked lanes: a Python loop over epochs,
    each ``epoch_pre`` (releases, evictions + migration policy, the
    compacted arrival stream) -> the batched placement engine ->
    ``epoch_post`` (outcomes, the deferral carry or SLO queue, emission
    accounting).  Both halves are loop-free masked tensor code over the
    (L, ...) axes.

    Returns (carry, ys): the final (cap, njobs, slot_jid, slot_node,
    slot_end, defer_ids, mig_cost, overflow[, mig_until, mig_nfail]), each
    (L, ...), and the per-epoch outputs stacked as (L, T, ...), all on the
    host.

    An epoch's releases are commutative capacity edits on a dirty engine,
    so they are applied as one scatter and the engine starts at the
    post-release capacity while the normalizers see the pre-release one;
    the best feasible rate per chip demand runs a cummax of free capacity
    along each region's static pue order plus a searchsorted.  Decisions
    read the observed CI (``traces``); emissions and migration cost read
    the true CI (``traces_true`` under faults, the same tensor without)."""
    (engine, shortlist, use_kernel, weights, horizon_h, history_h,
     use_forecast, defer_window) = statics
    T, S = dims.epochs, dims.slots
    L, N = arrs["capacity"].shape
    dev = arrs["capacity"].device
    budget = min(dims.budget, S)    # can't migrate more than can be active
    m_evict, d_cap, a_max = dims.m_evict, dims.d_cap, dims.a_max
    rel_cap, chips_max = dims.rel_cap, dims.chips_max
    pcfg = dims.policy
    faulty, fault_mig, fault_flap = dims.faults
    fault_mig = fault_mig and budget > 0
    slo = pcfg.deferral == "slo"
    planner = dims.planner and use_forecast
    n_ten, n_svc = dims.n_ten, dims.n_svc
    m_cap = budget + m_evict
    n_narr = d_cap + a_max
    has_defer = d_cap > 0
    alloc_cap = min(S, n_narr)
    EV = m_cap + n_narr             # padded event-buffer width
    INT_MAX = 2 ** 31 - 1
    inf = torch.inf
    chips_d, pue, ridx = arrs["chips"], arrs["pue"], arrs["ridx"]
    traces_true = arrs["traces_true"] if faulty else arrs["traces"]
    energies = [_lane_energy(arrs, l) for l in range(L)]
    cr = torch.arange(chips_max + 1, device=dev, dtype=torch.int32)
    i64 = dict(dtype=torch.int64, device=dev)
    empty = torch.zeros((L, 0), **i64)
    bins = torch.arange(n_ten + 1, device=dev)
    if slo:
        arange_d = torch.arange(d_cap, device=dev)

    def tenant_sum(tid, g):
        """(L, n_ten + 1) f64 per-bin sums of g (L, M) by tenant id tid
        (L, M): masked sums, so the order (and the result) is fixed on
        every device (no atomics)."""
        hit = tid[:, :, None] == bins
        return torch.where(hit, g.to(torch.float64)[:, :, None],
                           0.0).sum(1)

    def epoch_pre(st, t):
        cap, njobs, slot_jid, slot_node, slot_end, defer_ids, mig_cost, \
            overflow = st[:8]
        mig_until, mig_nfail = st[8:] if fault_mig else (None, None)
        a = t + history_h
        healthy = arrs["healthy"]
        for reg, t0, length in dims.outage:
            if t0 <= t < t0 + length:
                healthy = healthy & (ridx != reg)
        if fault_flap:
            healthy = healthy & arrs["f_elig"][:, t]
        ci_col_r = arrs["traces"][:, :, a]                       # (L, R)
        ci_col = ci_col_r.gather(1, ridx)                        # (L, N)
        ci_true = traces_true[:, :, a].gather(1, ridx) if faulty \
            else ci_col

        # ---- 1. end-of-life releases (one scatter) -----------------------
        rel_mask = (slot_jid >= 0) & (slot_end == t)
        completed_t = rel_mask.sum(1)
        rel_idx = _nonzero_sized(rel_mask, rel_cap, S)
        rel_valid = rel_idx < S
        rel_node = _take(slot_node, rel_idx, rel_valid, -1)
        rel_jid = _take(slot_jid, rel_idx, rel_valid, -1)
        rel_chips = _take(chips_d, rel_jid.clamp(min=0), rel_valid, 0)
        njobs = _scatter_drop(njobs, torch.where(rel_valid, rel_node, N),
                              -1, add=True)
        slot_jid = torch.where(rel_mask, -1, slot_jid)
        overflow = overflow + (completed_t - rel_cap).clamp(min=0)

        # ---- 2. forced evictions + migration policy ----------------------
        occupied = slot_jid >= 0
        node_healthy = _take(healthy, slot_node, occupied, False)
        stay_mask = occupied & node_healthy
        seg_slot, seg_ok = [], []
        evictions_t = migrations_t = failed_t = torch.zeros(L, **i64)
        mig_cost_t = torch.zeros(L, dtype=torch.float32, device=dev)
        mid = {}
        if m_evict > 0:
            evict_mask = occupied & ~node_healthy
            evictions_t = evict_mask.sum(1)
            ekey = torch.where(evict_mask, slot_jid, INT_MAX)
            ekey_s, evict_slot = torch.sort(ekey, dim=1, stable=True)
            seg_slot.append(evict_slot[:, :m_evict])
            seg_ok.append(ekey_s[:, :m_evict] < INT_MAX)
        if budget > 0:
            rate = torch.where(healthy, pue * ci_col, inf)
            # best achievable CFP rate per chip demand: within a region the
            # first prefix (in pue order) whose free-capacity cummax covers
            # the demand holds the region's least feasible rate
            perm, pue_sorted = arrs["mig_perm"], arrs["mig_pue"]
            nmax = perm.shape[2]
            flat = perm.reshape(L, -1)
            capg = _take(torch.where(healthy, cap, -1), flat, flat < N,
                         -1).reshape(perm.shape)
            cmax = torch.cummax(capg, dim=2).values.contiguous()
            idx = torch.searchsorted(
                cmax, cr.expand(cmax.shape[:2] + cr.shape).contiguous())
            ok = idx < nmax
            pb = pue_sorted.gather(2, idx.clamp(0, nmax - 1))
            best_ge = torch.where(ok, pb * ci_col_r[:, :, None],
                                  inf).amin(1)                   # (L, C+1)
            s_chips = _take(chips_d, slot_jid.clamp(min=0), stay_mask, 0)
            br = best_ge.gather(1, s_chips.clamp(0, chips_max))
            rate_cur = _take(rate, slot_node, stay_mask, inf)
            remaining = (slot_end - t).clamp(min=0).to(torch.float32)
            chips_f = s_chips.to(torch.float32)
            la_kw = {}
            if planner:
                la_node = arrs["la_ci"][:, t].gather(1, ridx) * pue
                la_kw = dict(
                    src_la=_take(la_node, slot_node, stay_mask, 0.0),
                    dst_la=arrs["la_dst"][:, t, None],
                    gw_min=arrs["gw_min"][:, t, None])
            gain = policylib.migration_gain(
                torch, pcfg, rate_cur=rate_cur, best_rate=br, chips=chips_f,
                remaining=remaining, e_kwh_h=arrs["en_ekwh"][:, None],
                ckpt=arrs["en_ckpt"][:, None] * chips_f,
                green_gate=arrs["green_gate"][:, None], **la_kw)
            if fault_mig:
                # retry with backoff: a slot whose last actuation failed
                # sits out the candidate sort until its backoff ends
                gain = torch.where(stay_mask & (mig_until > t), -inf, gain)
            if faulty:
                gain = policylib.degraded_gain(torch, gain,
                                               arrs["f_safe"][:, t, None])
            # (-gain, job id) order by two stable sorts, minor key first;
            # only gain > 0 is ever moved, so the order of ±0.0 ties (which
            # torch's sort and XLA's differ on) cannot change a mover
            mk1 = torch.where(stay_mask, -gain, inf)
            mk2 = torch.where(stay_mask, slot_jid, INT_MAX)
            o2 = torch.sort(mk2, dim=1, stable=True).indices
            o1 = torch.sort(mk1.gather(1, o2), dim=1, stable=True).indices
            mig_slot = o2.gather(1, o1)[:, :budget]
            mig_ok = stay_mask.gather(1, mig_slot) \
                & (gain.gather(1, mig_slot) > 0.0)
            if fault_mig:
                # attempt rank k draws fault stream mig_fail[t, k]: a failed
                # command uses up its budget slot (the job stays put,
                # nothing charged) and doubles the slot's backoff; a later
                # success resets it
                mfail = arrs["f_mig_fail"][:, t, :budget]
                fail = mig_ok & mfail
                mig_ok = mig_ok & ~mfail
                failed_t = fail.sum(1)
                nf1 = _take(mig_nfail, mig_slot, fail, 0) + 1
                until = t + arrs["mig_backoff"][:, None] \
                    * torch.bitwise_left_shift(torch.ones_like(nf1),
                                               (nf1 - 1).clamp(max=10))
                at_fail = torch.where(fail, mig_slot, S)
                at_ok = torch.where(mig_ok, mig_slot, S)
                mig_until = _scatter_drop(mig_until, at_fail, until,
                                          add=False)
                mig_nfail = _scatter_drop(mig_nfail, at_fail, nf1, add=False)
                mig_until = _scatter_drop(mig_until, at_ok, 0, add=False)
                mig_nfail = _scatter_drop(mig_nfail, at_ok, 0, add=False)
                mid.update(mig_until=mig_until, mig_nfail=mig_nfail)
            migrations_t = mig_ok.sum(1)
            mnode = slot_node.gather(1, mig_slot).clamp(0, N - 1)
            mjid = slot_jid.gather(1, mig_slot).clamp(min=0)
            mchip = chips_d.gather(1, mjid)
            # kept per mover so that attribution charges each move to its
            # mover's tenant
            mc_vec = torch.where(
                mig_ok, arrs["en_ckpt"][:, None] * mchip.to(torch.float32)
                * pue.gather(1, mnode) * ci_true.gather(1, mnode), 0.0)
            mig_cost_t = mc_vec.sum(1)
            if n_ten > 0:
                mid.update(mc_vec=mc_vec,
                           mig_ten=arrs["tenant"].gather(1, mjid))
            seg_slot.append(mig_slot)
            seg_ok.append(mig_ok)
        if m_cap > 0:
            mov_slot = torch.cat(seg_slot, dim=1)
            mov_ok = torch.cat(seg_ok, dim=1)
            mov_jid = _take(slot_jid, mov_slot, mov_ok, -1)
            mov_old = _take(slot_node, mov_slot, mov_ok, -1)
            mov_chips = _take(chips_d, mov_jid.clamp(min=0), mov_ok, 0)
            njobs = _scatter_drop(njobs, torch.where(mov_ok, mov_old, N),
                                  -1, add=True)
        else:
            mov_slot = mov_jid = mov_old = mov_chips = empty
            mov_ok = empty.to(torch.bool)

        # ---- 3. release credits, the compacted arrival stream -----------
        strag = arrs["straggler"] + dims.consolidate \
            * (njobs == 0).to(torch.float32)
        cap_start = _scatter_drop(
            cap, torch.where(rel_valid, rel_node, N), rel_chips, add=True)
        cap_start = _scatter_drop(
            cap_start, torch.where(mov_ok, mov_old, N), mov_chips, add=True)
        arr_row = arrs["arr_ids"][:, t]
        narr_jid = torch.cat([defer_ids, arr_row], 1) if has_defer \
            else arr_row
        narr_chips = _take(chips_d, narr_jid.clamp(min=0), narr_jid >= 0, 0)
        dem_full = torch.cat([mov_chips, narr_chips], dim=1)
        # pads are exact no-ops for the engine, so it walks only the real
        # arrivals (order kept) and stops at their count
        ev_idx = _nonzero_sized(dem_full > 0, EV, EV)
        n_ev = (dem_full > 0).sum(1)
        dem = _take(dem_full, ev_idx, ev_idx < EV, 0)
        if use_forecast:
            ci_fc = arrs["ci_fc_r"][:, t].gather(1, ridx)
            fut_rate = arrs["fut"][:, t]
        else:
            ci_fc = ci_col
            fut_rate = torch.full((L,), inf, device=dev)
        cur_rate = torch.where(healthy, ci_col * pue, inf).amin(1)
        mid.update(cap_ctx=cap, ci_col=ci_col, ci_true=ci_true, ci_fc=ci_fc,
                   healthy=healthy, strag=strag, cap_start=cap_start,
                   dem=dem, n_ev=n_ev, ev_idx=ev_idx, fut_rate=fut_rate,
                   cur_rate=cur_rate, njobs=njobs, slot_jid=slot_jid,
                   slot_node=slot_node, slot_end=slot_end,
                   mov_slot=mov_slot, mov_jid=mov_jid, narr_jid=narr_jid,
                   narr_chips=narr_chips, completed_t=completed_t,
                   evictions_t=evictions_t, migrations_t=migrations_t,
                   failed_t=failed_t, mig_cost=mig_cost + mig_cost_t,
                   overflow=overflow)
        return mid

    def epoch_post(mid, t, out_c, cap2, n_sw):
        slot_jid, slot_node = mid["slot_jid"], mid["slot_node"]
        slot_end, njobs = mid["slot_end"], mid["njobs"]
        mov_slot, mov_jid = mid["mov_slot"], mid["mov_jid"]
        narr_jid, narr_chips = mid["narr_jid"], mid["narr_chips"]
        overflow = mid["overflow"]
        fut_rate, cur_rate = mid["fut_rate"], mid["cur_rate"]
        out = _scatter_drop(torch.full((L, EV), -1, **i64), mid["ev_idx"],
                            out_c, add=False)

        # ---- 4. record outcomes ------------------------------------------
        placed_t = dropped_t = torch.zeros(L, **i64)
        if m_cap > 0:
            mnode_new = out[:, :m_cap]
            mov_win = (mov_jid >= 0) & (mnode_new >= 0)
            mov_fail = (mov_jid >= 0) & (mnode_new < 0)
            slot_node = _scatter_drop(
                slot_node, torch.where(mov_win, mov_slot, S), mnode_new,
                add=False)
            slot_jid = _scatter_drop(
                slot_jid, torch.where(mov_fail, mov_slot, S), -1, add=False)
            njobs = _scatter_drop(njobs, torch.where(mov_win, mnode_new, N),
                                  1, add=True)
            placed_t = placed_t + mov_win.sum(1)
            dropped_t = dropped_t + mov_fail.sum(1)
            ys_mov_node = torch.where(mov_win, mnode_new, -1)
        else:
            ys_mov_node = empty
        nnode = out[:, m_cap:]
        valid = narr_jid >= 0
        jsafe = narr_jid.clamp(min=0)
        if has_defer and slo:
            # SLO deferral: candidates that want to wait (green for their
            # own value-tightened threshold, or unplaced, inside their
            # slack window) compete for the fixed-capacity priority queue
            # on the (value asc, deadline desc, job id) key — the host's
            # lexsort, as three stable sorts (minor key first)
            slack_j = arrs["slack"].gather(1, jsafe)
            in_win = (t - arrs["arrive"].gather(1, jsafe)) < slack_j
            can_defer = valid & (slack_j > 0) & in_win
            green_j = policylib.wants_defer(
                fut_rate[:, None], cur_rate[:, None],
                arrs["thresh"].gather(1, jsafe))
            want = can_defer & torch.where(nnode >= 0, green_j, True)
            k1 = torch.where(want, arrs["value"].gather(1, jsafe), inf)
            k2 = torch.where(want, -arrs["deadline"].gather(1, jsafe),
                             INT_MAX)
            k3 = torch.where(want, narr_jid, INT_MAX)
            perm = torch.sort(k3, dim=1, stable=True).indices
            perm = perm.gather(1, torch.sort(k2.gather(1, perm), dim=1,
                                             stable=True).indices)
            perm = perm.gather(1, torch.sort(k1.gather(1, perm), dim=1,
                                             stable=True).indices)
            sel_idx = perm[:, :d_cap]
            sel_ok = torch.isfinite(k1.gather(1, sel_idx)) \
                & (arange_d < arrs["q_cap"][:, None])
            defer_again = _scatter_drop(
                torch.zeros((L, n_narr), dtype=torch.bool, device=dev),
                torch.where(sel_ok, sel_idx, n_narr), True, add=False)
            takeback = defer_again & (nnode >= 0)
            cap2 = _scatter_drop(cap2, torch.where(takeback, nnode, N),
                                 narr_chips, add=True)
            deferred_t = defer_again.sum(1)
            # the queue carries in priority order (overflow places this
            # epoch: no overflow accounting by design)
            defer_ids = torch.where(sel_ok, narr_jid.gather(1, sel_idx), -1)
        elif has_defer:
            green = policylib.wants_defer(fut_rate, cur_rate,
                                          arrs["green_factor"])
            in_win = (t - arrs["arrive"].gather(1, jsafe)) < dims.defer_max_h
            can_defer = valid & arrs["deferrable"].gather(1, jsafe) & in_win
            takeback = can_defer & green[:, None] & (nnode >= 0)
            defer_again = takeback | (can_defer & (nnode < 0))
            # taken-back placements release their chips again (the host
            # loop's pure-release redo call == a scatter)
            cap2 = _scatter_drop(cap2, torch.where(takeback, nnode, N),
                                 narr_chips, add=True)
            deferred_t = defer_again.sum(1)
            didx = _nonzero_sized(defer_again, d_cap, n_narr)
            defer_ids = _take(narr_jid, didx, didx < n_narr, -1)
            overflow = overflow + (deferred_t - d_cap).clamp(min=0)
        else:
            takeback = defer_again = torch.zeros_like(valid)
            deferred_t = torch.zeros(L, **i64)
            defer_ids = torch.full((L, d_cap), -1, **i64)
        place_new = valid & (nnode >= 0) & ~takeback
        drop_new = valid & (nnode < 0) & ~defer_again
        # a dropped job is a deadline miss only if it ever had start slack
        # (the host counts pol.slack > 0, defer_max_h-gated for reactive)
        if slo:
            slackable = arrs["slack"].gather(1, jsafe) > 0
        elif dims.defer_max_h > 0:
            slackable = arrs["deferrable"].gather(1, jsafe)
        else:
            slackable = torch.zeros_like(valid)
        miss_t = (drop_new & slackable).sum(1)
        free_idx = _nonzero_sized(slot_jid < 0, alloc_cap, S)
        rank = place_new.cumsum(1) - 1
        tgt_slot = torch.where(place_new & (rank < alloc_cap),
                               free_idx.gather(1, rank.clamp(0,
                                                             alloc_cap - 1)),
                               S)
        overflow = overflow + (place_new & (tgt_slot >= S)).sum(1)
        slot_jid = _scatter_drop(slot_jid, tgt_slot, narr_jid, add=False)
        slot_node = _scatter_drop(slot_node, tgt_slot, nnode, add=False)
        slot_end = _scatter_drop(slot_end, tgt_slot,
                                 t + arrs["duration"].gather(1, jsafe),
                                 add=False)
        njobs = _scatter_drop(njobs, torch.where(place_new, nnode, N), 1,
                              add=True)
        placed_t = placed_t + place_new.sum(1)
        dropped_t = dropped_t + drop_new.sum(1)

        # ---- 5. emission accounting (f32 on the device, at the TRUE CI) --
        on = (njobs > 0) if dims.power_off_idle \
            else torch.ones((L, N), dtype=torch.bool, device=dev)
        occ = 1.0 - cap2.to(torch.float32) \
            / arrs["chips_total"].to(torch.float32).clamp(min=1.0)
        energy = arrs["power_kw"] * (arrs["en_idle"][:, None]
                                     + arrs["en_dyn"][:, None] * occ) * on
        node_g = energy * pue * mid["ci_true"] \
            + arrs["en_embodied"][:, None] * on
        e_t = node_g.sum(1)
        ys = {}
        if n_ten > 0:
            # attribution from the post-update slot table: each on-node's
            # gCO2 split across its resident jobs by chips; the
            # idle/rounding remainder goes to bin n_ten; sums in float64
            occ3 = slot_jid >= 0
            s_jid = slot_jid.clamp(min=0)
            s_chips = torch.where(occ3, chips_d.gather(1, s_jid),
                                  0).to(torch.float32)
            occ_chips = _scatter_drop(
                torch.zeros((L, N), dtype=torch.float32, device=dev),
                torch.where(occ3, slot_node, N), s_chips, add=True)
            share = node_g / occ_chips.clamp(min=1.0)
            contrib = torch.where(
                occ3, share.gather(1, slot_node.clamp(0, N - 1)) * s_chips,
                0.0)
            ten_t = tenant_sum(torch.where(
                occ3, arrs["tenant"].gather(1, s_jid), n_ten), contrib)
            ten_t[:, n_ten] += e_t.to(torch.float64) \
                - contrib.to(torch.float64).sum(1)
            if budget > 0:
                # migration overhead is charged to the mover's tenant
                ten_t = ten_t + tenant_sum(mid["mig_ten"], mid["mc_vec"])
            ys["ten_t"] = ten_t
        if n_svc > 0:
            # ---- 5b. request routing + serving attribution ---------------
            # lanes are the post-update slot tables (the host loop routes
            # over the end-of-epoch active jobs); the DECISION reads the
            # observed CI column, the ATTRIBUTION the true one; the counts
            # stay on the device with the other outputs (no read-back)
            occ_r = slot_jid >= 0
            r_jid = slot_jid.clamp(min=0)
            svc_l = torch.where(occ_r, arrs["svc"].gather(1, r_jid), -1)
            w_l = torch.where(occ_r, arrs["qweight"].gather(1, r_jid), 0)
            chips_l = torch.where(occ_r, chips_d.gather(1, r_jid), 0)
            cap_l = torch.where(occ_r, arrs["lam_cap"].gather(
                1, chips_l.clamp(0, chips_max)), 0)
            node_l = slot_node.clamp(0, N - 1)
            pue_l = pue.gather(1, node_l)
            carbon_l = pue_l * mid["ci_col"].gather(1, node_l)
            routed, offered = routerlib.route_epoch_batched(
                req_t=arrs["tr_req"][:, t], svc=svc_l, jid=slot_jid,
                weight=w_l, cap=cap_l, carbon=carbon_l, n_svc=n_svc,
                greenness=arrs["greenness"])
            g_lane = routed.to(torch.float32) * (
                arrs["en_reqkwh"][:, None]
                * (pue_l * mid["ci_true"].gather(1, node_l)))
            p99_l = routerlib.modeled_p99(torch, routed, chips_l, chips_max,
                                          arrs["tr_mu"][:, None])
            # the float sums in float64: no atomics, and each device's
            # order moves them far less than the reference's f32 sums
            ys.update(
                served_t=routed.sum(1, dtype=torch.int64),
                offered_t=offered[:, :n_svc].sum(1, dtype=torch.int64),
                viol_t=((routed > cap_l) & (svc_l >= 0)).sum(1),
                reqg_t=g_lane.to(torch.float64).sum(1),
                p99w_t=(routed.to(torch.float32) * p99_l).to(
                    torch.float64).sum(1))
            if n_ten > 0:
                ys["tenreq_t"] = tenant_sum(torch.where(
                    occ_r, arrs["tenant"].gather(1, r_jid), n_ten), g_lane)
        carry = (cap2, njobs, slot_jid, slot_node, slot_end, defer_ids,
                 mid["mig_cost"], overflow)
        if fault_mig:
            # a reused slot belongs to a fresh job with no failure history
            carry += (_scatter_drop(mid["mig_until"], tgt_slot, 0,
                                    add=False),
                      _scatter_drop(mid["mig_nfail"], tgt_slot, 0,
                                    add=False))
        ys.update(e_t=e_t, n_sw=n_sw,
                  completed_t=mid["completed_t"], dropped_t=dropped_t,
                  placed_t=placed_t, deferred_t=deferred_t,
                  mig_t=mid["migrations_t"], evi_t=mid["evictions_t"],
                  failed_t=mid["failed_t"], miss_t=miss_t,
                  mov_jid=mov_jid, mov_node=ys_mov_node,
                  new_jid=torch.where(place_new, narr_jid, -1),
                  new_node=torch.where(place_new, nnode, -1),
                  ov_t=overflow)
        return carry, ys

    st = (arrs["capacity"], torch.zeros((L, N), **i64),
          torch.full((L, S), -1, **i64), torch.zeros((L, S), **i64),
          torch.zeros((L, S), **i64), torch.full((L, d_cap), -1, **i64),
          torch.zeros(L, dtype=torch.float32, device=dev),
          torch.zeros(L, **i64))
    if fault_mig:
        st += (torch.zeros((L, S), **i64), torch.zeros((L, S), **i64))
    ys_all = []
    for t in range(T):
        mid = epoch_pre(st, t)
        # the Fleet _place_epoch builds, with (L, N) leaves
        fleet = Fleet(ci_now=mid["ci_col"], ci_forecast=mid["ci_fc"],
                      pue=pue, power_kw=arrs["power_kw"],
                      capacity=mid["cap_ctx"], healthy=mid["healthy"],
                      straggler_score=mid["strag"],
                      flops_per_j=arrs["flops_per_j"],
                      chips_total=arrs["chips_total"])
        out_c, cap2, n_sw = place_lifecycle_batched(
            fleet, mid["dem"], weights, horizon_h=1.0, engine=engine,
            shortlist=shortlist, use_kernel=use_kernel,
            capacity=mid["cap_start"], n_events=mid["n_ev"],
            energy=energies, syncs=syncs)
        st, ys = epoch_post(mid, t, out_c, cap2, n_sw)
        ys_all.append(ys)
    carry = [c.cpu().numpy() for c in st]
    ys = {k: torch.stack([y[k] for y in ys_all], dim=1).cpu().numpy()
          for k in ys_all[0]}
    return carry, ys


def _scan_result(run: _ScanRun, carry, ys, host_syncs: int) -> SimResult:
    """Unpack one lane's (carry, ys) into a ``SimResult`` on the host."""
    jobs, plan, T, J = run.jobs, run.plan, run.cfg.epochs, run.jobs.n
    defer_f, mig_cost_f, overflow_f = carry[5], carry[6], carry[7]
    if int(overflow_f) != 0:
        bad = int(np.argmax(ys["ov_t"] > 0))  # first epoch whose cumulative
        raise RuntimeError(                   # overflow count is nonzero
            f"scanned simulator overflowed its static job-slot capacity "
            f"S={plan.slots} at epoch {bad}: {int(overflow_f)} event(s) "
            f"beyond ScanPlan(slots={plan.slots}, a_max={plan.a_max}, "
            f"d_cap={plan.d_cap}, rel_cap={plan.rel_cap}, "
            f"m_evict={plan.m_evict}).  The sound bound should never be "
            f"exceeded — please report; as a workaround, rerun with "
            f"SimConfig(scan_slots={plan.slots + int(overflow_f)}) to "
            f"widen the job table")
    series = ys["e_t"].astype(np.float64)
    # replay the per-event placement log chronologically: within an epoch
    # movers precede new arrivals (host step-4 order); a job appears at
    # most once per epoch, so first/last occurrence give first/final node
    ev_jid = np.concatenate([ys["mov_jid"], ys["new_jid"]], axis=1).ravel()
    ev_node = np.concatenate([ys["mov_node"], ys["new_node"]],
                             axis=1).ravel()
    mask = (ev_jid >= 0) & (ev_node >= 0)
    j_m, n_m = ev_jid[mask], ev_node[mask]
    node_log = np.full(J, -1, np.int64)
    first_node = np.full(J, -1, np.int64)
    uniq, first_idx = np.unique(j_m, return_index=True)
    first_node[uniq] = n_m[first_idx]
    uniq_r, last_idx = np.unique(j_m[::-1], return_index=True)
    node_log[uniq_r] = n_m[::-1][last_idx]
    # a first placement always comes through the arrival stream, so the
    # new-arrival log rows give the start epochs
    new_jid, new_node = ys["new_jid"], ys["new_node"]
    ep_rows = np.repeat(np.arange(T, dtype=np.int64), new_jid.shape[1])
    nmask = (new_jid.ravel() >= 0) & (new_node.ravel() >= 0)
    start_epoch = np.full(J, -1, np.int64)
    uniq_s, first_s = np.unique(new_jid.ravel()[nmask], return_index=True)
    start_epoch[uniq_s] = ep_rows[nmask][first_s]
    started = start_epoch >= 0
    delay_h = int((start_epoch[started]
                   - np.asarray(jobs.arrive)[started]).sum())
    # jobs still waiting in the deferral carry never ran -> dropped, and
    # (every carried job has slack > 0) a deadline miss
    still_q = int((defer_f >= 0).sum())
    mig_cost = float(mig_cost_f)
    tenant_g = None
    n_run = run.cfg.n_tenants
    if n_run:
        # the bucket's bins may be wider than this run's tenant count: its
        # extra bins are zero, and the idle/remainder bin sits last
        tg = ys["ten_t"].sum(axis=0)
        tenant_g = np.concatenate([tg[:n_run], tg[-1:]])
    req_kw = {}
    if "served_t" in ys:
        served = int(ys["served_t"].sum())
        req_kw = dict(req_served=served,
                      req_offered=int(ys["offered_t"].sum()),
                      p99_violations=int(ys["viol_t"].sum()),
                      req_gco2=float(ys["reqg_t"].sum()),
                      req_p99_s=float(ys["p99w_t"].sum()) / max(served, 1))
        if n_run:
            tr = ys["tenreq_t"].sum(axis=0)
            req_kw["tenant_request_g"] = np.concatenate([tr[:n_run],
                                                         tr[-1:]])
    return SimResult(
        emissions_g=float(series.sum()) + mig_cost,
        migration_cost_g=mig_cost,
        rank_sweeps=int(ys["n_sw"].sum()),
        arrivals_placed=int(ys["placed_t"].sum()),
        jobs_completed=int(ys["completed_t"].sum()),
        jobs_dropped=int(ys["dropped_t"].sum()) + still_q,
        jobs_deferred=int(ys["deferred_t"].sum()),
        migrations=int(ys["mig_t"].sum()),
        evictions=int(ys["evi_t"].sum()),
        node_log=node_log, first_node=first_node,
        emissions_series=series,
        deadline_misses=int(ys["miss_t"].sum()) + still_q,
        defer_delay_h=delay_h,
        migrations_failed=int(ys["failed_t"].sum()),
        jobs_active_end=int((carry[2] >= 0).sum()),
        safe_epochs=int(run.fplan.safe.sum())
        if run.fplan is not None else 0,
        start_epoch=start_epoch, tenant_emissions_g=tenant_g,
        host_syncs=host_syncs, **req_kw)


def _world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def _lane_split(n_lanes: int) -> Tuple[int, int]:
    """(ranks the lanes split over, this rank): the largest divisor of
    the lane count that is <= the world size, as the reference's
    ``_shard_over_e`` takes it over devices."""
    world = _world_size()
    nd = max(d for d in range(1, world + 1) if n_lanes % d == 0)
    return nd, (dist.get_rank() if nd > 1 else 0)


def _run_bucket(members, pad_plan: bool, shard: bool = False) -> list:
    """One bucket of prepared runs as ONE batched trajectory; results in
    member order.  ``shard``: this rank runs its contiguous block of the
    lanes, at the buffer sizes of the whole bucket, and every rank gets
    every lane's result (``all_gather_object``)."""
    dims, jp, nmax = _shared_dims(members, pad_plan)
    nd, rank = _lane_split(len(members)) if shard else (1, 0)
    if nd > 1:
        per = len(members) // nd
        mine = (_run_lanes(members[rank * per:(rank + 1) * per], dims, jp,
                           nmax) if rank < nd else [])
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, mine)
        return [r for part in parts[:nd] for r in part]
    return _run_lanes(members, dims, jp, nmax)


def _run_lanes(members, dims: _Dims, jp: int, nmax: int) -> list:
    """Lanes at the given shared buffer sizes as ONE batched trajectory."""
    cache: dict = {}
    built = [_build_arrs(m, dims, jp, nmax, cache) for m in members]
    stacked = {k: torch.stack([b[k] for b in built]) for k in built[0]}
    del built
    syncs = HostSyncs()
    carry, ys = _trajectory(stacked, members[0].statics, dims, syncs)
    return [_scan_result(m, [c[l] for c in carry],
                         {k: v[l] for k, v in ys.items()}, syncs.n)
            for l, m in enumerate(members)]


def simulate_fleet_scan(fleet0: Fleet, region_ci: np.ndarray,
                        ridx: np.ndarray, cfg: SimConfig,
                        jobs: Optional[JobSchedule] = None, *,
                        pad_plan: bool = False) -> SimResult:
    """``simulate_fleet`` with the epoch loop driven over a fixed-capacity
    job-slot table and padded event buffers (``ScanPlan``) on
    ``fleet0``'s device: the ensemble's trajectory at one lane.

    Same trajectory semantics as the host loop for ``engine in
    ("shortlist", "full")`` — arrivals, end-of-life releases, outage
    evictions, budget/cost-model migration, deferrable batch jobs.  The
    job bookkeeping is masked tensor code on the device, and the
    accounting is f32 there; the placement events of each epoch go
    through ``placement.place_lifecycle_batched``.

    Equivalence contract (the reference's): placements (``node_log``,
    ``first_node``), start epochs and every integer counter match the host
    loop exactly; ``emissions_g``, ``emissions_series`` and
    ``migration_cost_g`` to f32 accumulation tolerance (rel 1e-4; the host
    loop accounts in f64 numpy).  Integer divergence could only come from
    f32-vs-f64 near-ties in the migration-gain order or the deferral
    green-hour test.  ``pad_plan`` rounds every buffer to ``_pad_bucket``
    sizes (behaviour-neutral).  ``SimResult.host_syncs`` counts the reads
    the device waited for."""
    run = _prepare_scan_run(fleet0, region_ci, ridx, cfg, jobs, pad_plan)
    return _run_bucket([run], pad_plan)[0]


def simulate_fleet_ensemble(runs, *, pad_plan: bool = True,
                            shard=False) -> list:
    """Run an ensemble of trajectories as ONE batched trajectory per graph
    bucket.

    ``runs`` is a sequence of ``(fleet0, region_ci, ridx, cfg)`` or
    ``(fleet0, region_ci, ridx, cfg, jobs)`` tuples — the arguments
    ``simulate_fleet_scan`` takes; the result list matches input order and
    each member equals ``simulate_fleet_scan`` on it (placements and every
    integer counter exact, emissions to the f32 accounting's tolerance).

    Members are grouped by ``_bucket_key`` (placement statics, epochs,
    fleet/trace shapes, graph-shaping config fields, the policy's
    ``graph_key`` and the device), so a threshold grid over one seed set is
    a single bucket; within a bucket every input is stacked on a leading
    lane axis and buffer sizes are the member-wise maxima.  Each epoch's
    placement is one ``place_lifecycle_batched`` call for all lanes:
    ``use_kernel=True`` lanes run one K4 launch per placement round.
    ``shard=True`` (or ``"e"``) splits each bucket's lanes over the ranks
    of the default process group: the largest divisor of the bucket's
    lane count that is <= the world size, each rank a contiguous block
    of lanes at the whole bucket's buffer sizes.  Every rank calls with
    the same ``runs`` and gets the whole result list in input order.
    Without a process group, or in a world of one, it is the unsharded
    program, as the reference's one-device mesh is.  ``"en"`` (lanes,
    then the fleet's node axis) over more than one rank is not ported
    (ROADMAP Queue 1 slice (C))."""
    _check_shard(shard)
    preps = [_prepare_scan_run(spec[0], spec[1], spec[2], spec[3],
                               spec[4] if len(spec) > 4 else None, pad_plan)
             for spec in runs]
    buckets: Dict[tuple, list] = {}
    for i, p in enumerate(preps):
        buckets.setdefault(_bucket_key(p), []).append(i)
    results: list = [None] * len(preps)
    for idxs in buckets.values():
        for i, r in zip(idxs, _run_bucket([preps[i] for i in idxs],
                                          pad_plan, bool(shard))):
            results[i] = r
    return results


def _check_shard(shard) -> None:
    """Validate ``shard``: ``"en"``'s node split over more than one rank
    is not ported; every other form runs (the unsharded program in a
    world of one)."""
    if shard == "en" and _world_size() > 1:
        raise NotImplementedError(
            "shard='en' over more than one rank — the ('e', 'n') mesh's "
            "node split, with its cross-shard top-k merge — is not ported "
            "to repro_torch yet (ROADMAP Queue 1 slice (C))")


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
# policy Pareto sweep harness
# ---------------------------------------------------------------------------


def sweep_policies(cfg: SimConfig, policies, *, n: int = 1024,
                   seeds=(0,), chips_per_node: int = 256,
                   region: Optional[int] = None, ensemble: bool = True,
                   shard=False, device: DeviceLike = None) -> list:
    """Run a seed ensemble per policy through the scanned core and return
    flat records for the carbon-vs-latency Pareto study.

    ``policies`` maps name -> ``PolicyConfig`` (a dict or (name, cfg)
    pairs); each (policy, seed) pair re-derives the fleet (on ``device``,
    the card by default), traces and job schedule from
    ``dataclasses.replace(cfg, seed=seed, policy=pcfg)``.  ``ensemble=True``
    runs the whole grid through ``simulate_fleet_ensemble`` (points whose
    policies share a ``graph_key`` become lanes of one batched
    trajectory); ``ensemble=False`` runs ``simulate_fleet_scan`` point by
    point.  Both pad the plans, and the records are equal either way.
    Latency is reported as ``avg_start_delay_h`` (mean placement delay
    over started jobs) and ``miss_rate`` (deadline misses over
    slack-carrying jobs inside the horizon)."""
    items = policies.items() if isinstance(policies, dict) else policies
    fleet_cache: Dict[int, tuple] = {}   # fleet/traces depend on seed only
    runs, metas = [], []
    for name, pcfg in items:
        for seed in seeds:
            c = dataclasses.replace(cfg, seed=int(seed), policy=pcfg)
            if int(seed) not in fleet_cache:
                fleet_cache[int(seed)] = synthetic_lifecycle_fleet(
                    n, c, chips_per_node=chips_per_node, region=region,
                    device=device)
            fleet, traces, ridx = fleet_cache[int(seed)]
            jobs = generate_jobs(c)
            runs.append((fleet, traces, ridx, c, jobs))
            metas.append((name, int(seed), c, jobs))
    if ensemble:
        rs = simulate_fleet_ensemble(runs, pad_plan=True, shard=shard)
    else:
        _check_shard(shard)
        rs = [simulate_fleet_scan(f, t, ri, c, jobs=j, pad_plan=True)
              for f, t, ri, c, j in runs]
    records = []
    for (name, seed, c, jobs), r in zip(metas, rs):
        pol = Policy.for_jobs(c.policy, jobs.arrive, jobs.deferrable,
                              c.defer_max_h, jobs.deadline, jobs.value)
        in_h = np.asarray(jobs.arrive) < c.epochs
        slo_jobs = int(((pol.slack > 0) & in_h).sum())
        started = int((r.start_epoch >= 0).sum())
        records.append({
            "policy": name, "seed": seed, "n": n,
            "epochs": c.epochs, "jobs": int(jobs.n),
            "emissions_g": float(r.emissions_g),
            "migration_cost_g": float(r.migration_cost_g),
            "migrations": int(r.migrations),
            "completed": int(r.jobs_completed),
            "dropped": int(r.jobs_dropped),
            "deferred": int(r.jobs_deferred),
            "deadline_misses": int(r.deadline_misses),
            "defer_delay_h": int(r.defer_delay_h),
            "avg_start_delay_h": r.defer_delay_h / max(started, 1),
            "miss_rate": r.deadline_misses / max(slo_jobs, 1),
        })
    return records


def pareto_frontier(records: list, x: str = "avg_start_delay_h",
                    y: str = "emissions_g") -> list:
    """Seed-aggregate ``sweep_policies`` records per policy (mean) and
    return the non-dominated carbon/latency frontier, sorted by ``x``
    ascending — ``y`` strictly decreases along the result."""
    by: Dict[str, list] = {}
    for r in records:
        by.setdefault(r["policy"], []).append(r)
    pts = []
    for name, rs in by.items():
        p = {"policy": name,
             "seeds": sorted(r["seed"] for r in rs),
             "miss_rate": float(np.mean([r["miss_rate"] for r in rs]))}
        p[x] = float(np.mean([r[x] for r in rs]))
        p[y] = float(np.mean([r[y] for r in rs]))
        pts.append(p)
    pts.sort(key=lambda p: (p[x], p[y]))
    front, best = [], np.inf
    for p in pts:
        if p[y] < best:
            front.append(p)
            best = p[y]
    return front


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
