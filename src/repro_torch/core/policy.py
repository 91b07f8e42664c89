"""Carbon policy subsystem: pluggable migration + deferral policies.

The port's own copy of ``repro.core.policy`` (pure numpy, so it is copied
as it is; the port imports nothing of the JAX package).  The shared
expressions run with ``xp=numpy`` in the host loop and ``xp=torch`` on the
scanned driver's device tensors, in the reference's op order.  All three
of the port's drivers (host loop, scanned driver, ensemble) run every
policy below.

MAIZX's headline reduction comes from acting on *forecasted* carbon
intensity, yet the simulator's original policies were reactive: the
migration gain read ``ci_now`` and deferral was a fixed
``fut < 0.95 * cur`` threshold with no notion of deadlines or job value.
This module is the single home for both policy call sites — the host loop
(``simulator.simulate_fleet``) and the scanned core
(``simulate_fleet_scan``) consume the SAME expressions through one
``Policy`` object, so the two drivers cannot drift.  Three concrete
policies ship:

- **reactive** (the parity oracle): migrate when the instantaneous CFP-rate
  spread beats the checkpoint cost; defer a deferrable job whenever any
  forecast hour inside the defer window is greener than
  ``defer_green_factor`` x the current best rate.  Routed through this
  interface it is bit-identical to the pre-policy-subsystem trajectories
  (asserted by the golden snapshots in ``tests/test_policy.py`` and the
  committed bench baselines).

- **green-window planner** (``migration="lookahead"``): the migration gain
  replaces the persist-the-present assumption with a discounted look-ahead
  over the precomputed ``(T, R)`` forecast tensor
  (``forecast.green_window_signals``): benefit integrates the *forecast*
  rate of staying put minus the greenest discounted region, and moves are
  gated into forecast-green windows — migrate only when the best currently
  achievable rate is within ``green_gate`` x of the greenest moment in the
  next ``lookahead_h`` hours.  Batching moves into green windows both
  cheapens the checkpoint overhead (charged at the source's CI) and lands
  jobs where the forecast — not a transient dip — says they should be.
  The per-epoch ``migration_budget`` and the gCO2 checkpoint cost model
  are unchanged.

- **SLO-aware deferral** (``deferral="slo"``): the static-shape deferral
  carry generalizes to a fixed-capacity priority queue keyed by
  ``(value asc, deadline desc, job id)`` — cheap, flexible batch work
  rides green windows while urgent or valuable jobs place immediately.
  Each job gets a start *deadline* (``arrive + slack``) and a value; the
  green threshold tightens exponentially with value
  (``thresh_j = defer_green_factor * exp(-value_weight * value_j)``), a
  job past its deadline can no longer defer, and a job that never starts
  by its deadline is dropped and accounted as a **deadline miss**.  Queue
  overflow forces the lowest-priority candidates to place immediately
  rather than silently dropping them.

Every numeric expression that must agree across drivers is written once,
parameterized over the array namespace (``xp`` = numpy on the host path,
``torch`` in the scanned driver), with per-path precision following the
established simulator convention (host f64 accounting, scan f32; ordering
near-ties are the only possible divergence and none are observed on the
tested streams).  Per-job columns (slack, value, green threshold,
deadline epoch) are derived ONCE on the host in float32 and shared by
both paths, so threshold comparisons see identical constants.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "PolicyConfig", "Policy", "REACTIVE", "green_window", "slo_deferral",
    "migration_gain", "wants_defer", "slo_queue_order", "sound_queue_bound",
    "degraded_gain", "degraded_future",
]


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Hashable policy knobs — part of the jit statics of both drivers.

    ``migration`` / ``deferral`` select the policy mix; the remaining
    fields parameterize the non-reactive policies (and
    ``defer_green_factor``, lifted out of the old hardcoded ``0.95``
    literal, parameterizes all of them)."""
    migration: str = "reactive"      # reactive | lookahead
    deferral: str = "reactive"       # reactive | slo
    # deferral green threshold (was a 0.95 literal duplicated between the
    # host and scan paths of simulator.py — now threaded through both via
    # the shared statics so they cannot drift)
    defer_green_factor: float = 0.95
    # --- green-window planner (migration="lookahead") ---
    # defaults calibrated at N=4096/T=8760 over seed ensembles (see
    # EXPERIMENTS.md §Policy): the discounted forecast-integrated benefit
    # does most of the work (it stops reactive's chasing of transient
    # dips); the loose 1.4 gate trims mistimed moves without the
    # spread-hour losses tighter gates (1.05-1.15) pay for over-waiting
    lookahead_h: int = 12            # forecast hours the gain integrates
    discount: float = 0.9            # per-hour decay of forecast trust
    green_gate: float = 1.4          # move only when best-now <= gate*window-min
    # --- SLO deferral (deferral="slo") ---
    queue_cap: int = 0               # 0 -> sound bound from the schedule
    value_weight: float = 0.5        # value -> green-threshold tightening
    deadline_lo: int = 1             # per-job start-slack draw, inclusive
    deadline_hi: int = 0             # 0 -> defer_max_h
    # --- QPS router (active when SimConfig.traffic is set) ---
    # Both reach the compiled graph as traced data (the host-built
    # lambda_caps table and the per-run greenness scalar), so a
    # (latency-SLO x greenness) grid shares one compiled trajectory.
    router_slo_s: float = 2.0        # per-request p99 latency SLO (s)
    router_greenness: float = 1.0    # γ: carbon water-fill vs even split

    def __post_init__(self):
        if self.migration not in ("reactive", "lookahead"):
            raise ValueError(f"unknown migration policy: {self.migration!r}")
        if self.deferral not in ("reactive", "slo"):
            raise ValueError(f"unknown deferral policy: {self.deferral!r}")

    def graph_key(self) -> "PolicyConfig":
        """Canonical copy with every graph-irrelevant knob pinned, for use
        as the scanned core's jit-static: sweep grid points whose knobs
        reach the traced graph only through traced per-run data
        (``value_weight``/``queue_cap``/deadline draws via per-job
        columns; ``defer_green_factor`` via the per-run ``green_factor``
        scalar or, under SLO, the per-job ``thresh`` column;
        ``green_gate`` via the per-run ``green_gate`` scalar;
        ``router_slo_s``/``router_greenness`` via the host-built
        ``lambda_caps`` table and the per-run greenness scalar) then hash
        to the SAME static and share one compiled trajectory — the
        compile-sharing ``sweep_policies`` and the batched ensemble
        (``simulator.simulate_fleet_ensemble``) both rely on it.  Only
        ``migration``/``deferral`` (graph structure) and
        ``lookahead_h``/``discount`` under the planner (forecast-tensor
        shape/weights) remain graph-relevant."""
        kw = dict(value_weight=0.0, queue_cap=0, deadline_lo=1,
                  deadline_hi=0, defer_green_factor=0.0, green_gate=1.4,
                  router_slo_s=2.0, router_greenness=1.0)
        if self.migration != "lookahead":
            kw.update(lookahead_h=12, discount=0.9)
        return dataclasses.replace(self, **kw)


REACTIVE = PolicyConfig()


def green_window(lookahead_h: int = 12, discount: float = 0.9,
                 green_gate: float = 1.4, **kw) -> PolicyConfig:
    """Forecast-driven proactive migration, reactive deferral."""
    return PolicyConfig(migration="lookahead", lookahead_h=lookahead_h,
                        discount=discount, green_gate=green_gate, **kw)


def slo_deferral(defer_green_factor: float = 0.95,
                 value_weight: float = 0.5, queue_cap: int = 0,
                 deadline_lo: int = 1, deadline_hi: int = 0,
                 **kw) -> PolicyConfig:
    """Deadline/value priority-queue deferral, reactive migration."""
    return PolicyConfig(deferral="slo",
                        defer_green_factor=defer_green_factor,
                        value_weight=value_weight, queue_cap=queue_cap,
                        deadline_lo=deadline_lo, deadline_hi=deadline_hi,
                        **kw)


# ---------------------------------------------------------------------------
# shared expressions (xp = np on the host path, torch in the scanned core)
# ---------------------------------------------------------------------------


def migration_gain(xp, pcfg: PolicyConfig, *, rate_cur, best_rate, chips,
                   remaining, e_kwh_h, ckpt, src_la=None, dst_la=None,
                   gw_min=None, green_gate=None):
    """Per-job migration gain in gCO2 (positive => worth moving).

    Reactive: persist-the-present — the CFP-rate spread between the job's
    node and the best capacity-feasible node, integrated over the job's
    remaining hours, minus the checkpoint/restore carbon cost charged at
    the source rate.  ``ckpt`` is the per-job checkpoint energy (kWh),
    already scaled by the job's chips, so both drivers keep their exact
    historical arithmetic (host: f64 ``job_energy_kwh`` per job; scan:
    f32 per-chip constant x chips).

    Look-ahead (``src_la``/``dst_la``/``gw_min`` provided): the spread is
    taken between the *discounted forecast* rate of staying put and the
    greenest discounted region (``forecast.green_window_signals``), and
    the whole move is gated into forecast-green windows: only when the
    best currently-achievable rate is within ``green_gate`` x of the
    greenest moment inside the look-ahead window does the gain survive
    (otherwise -inf — wait for the window instead of moving into a
    transient).  ``best_rate`` stays the capacity-feasible reactive bound,
    so a gated move is always landable.

    ``green_gate`` overrides ``pcfg.green_gate``: the scanned core passes
    its traced per-run float32 scalar (so gate grids share one compiled
    trajectory — see ``PolicyConfig.graph_key``); the host loop omits it
    and keeps the historical f64 constant."""
    if pcfg.migration == "reactive" or src_la is None:
        benefit = (rate_cur - best_rate) * e_kwh_h * chips * remaining
        return benefit - ckpt * rate_cur
    benefit = (src_la - dst_la) * e_kwh_h * chips * remaining
    gain = benefit - ckpt * rate_cur
    gg = pcfg.green_gate if green_gate is None else green_gate
    gate = best_rate <= gg * gw_min
    return xp.where(gate, gain, -xp.inf)


def degraded_gain(xp, gain, safe):
    """Safe-mode migration freeze: when the fleet's CI signal is stale
    beyond ``faults.FaultConfig.safe_stale_h`` (the traced per-epoch
    ``safe`` flag), every migration gain collapses to ``-inf`` — moving on
    garbage telemetry risks paying real checkpoint carbon for an imagined
    win, so the degraded operator holds still until signal returns.
    Written once over ``xp`` so the host loop (numpy) and the scanned
    driver (torch) freeze identically."""
    return xp.where(safe, -xp.inf, gain)


def degraded_future(xp, fut_rate, safe):
    """Safe-mode green-window freeze: an ``inf`` future rate makes
    ``wants_defer`` false for every job (and the SLO queue drains on
    deadlines only) — deferral stops chasing forecast dips the stale
    signal can no longer see.  Same single-expression contract as
    ``degraded_gain``."""
    return xp.where(safe, xp.inf, fut_rate)


def wants_defer(fut_rate, cur_rate, thresh):
    """Greener-hour signal: some forecast hour inside the defer window
    beats ``thresh`` x the current best rate.  ``thresh`` is the per-job
    float32 column (a scalar ``defer_green_factor`` for reactive), and
    callers evaluate this in their native precision — f32 on both paths
    for SLO (bit-identical), the historical f64 scalar on the reactive
    host path."""
    return fut_rate < thresh * cur_rate


def slo_queue_order(value: np.ndarray, deadline_ep: np.ndarray,
                    jid: np.ndarray) -> np.ndarray:
    """Host-side priority order for SLO queue admission: value ascending,
    then deadline DESCENDING, then job id — cheap, flexible work wins
    queue slots; urgent/valuable overflow places immediately.  The
    scanned driver sorts on the identical ``(value, -deadline_ep, jid)``
    key tuple (three stable ``torch.sort`` passes, minor key first), so
    admission and the resulting queue storage order match bit-for-bit
    (value is the shared f32 column)."""
    return np.lexsort((jid, -np.asarray(deadline_ep, np.int64),
                       np.asarray(value, np.float32)))


def sound_queue_bound(arrive: np.ndarray, slack: np.ndarray,
                      epochs: int) -> int:
    """Sound upper bound on deferral-queue occupancy: job j can sit in the
    carry only during ``[arrive+1, arrive+slack]`` (it defers at epoch
    ``arrive`` at the earliest, and the last in-window defer decision at
    ``arrive+slack-1`` carries into ``arrive+slack``).  The max runs
    through epoch ``epochs`` INCLUSIVE: deferrals taken at the final
    epoch still occupy the carry-out buffer even though no epoch consumes
    it."""
    arrive = np.asarray(arrive, np.int64)
    slack = np.asarray(slack, np.int64)
    m = (arrive < epochs) & (slack > 0)
    if not m.any():
        return 0
    hi = epochs + int(slack.max(initial=0)) + 2
    diff = np.zeros(hi, np.int64)
    np.add.at(diff, arrive[m] + 1, 1)
    np.add.at(diff, np.minimum(arrive[m] + slack[m] + 1, hi - 1), -1)
    return int(np.cumsum(diff)[:epochs + 1].max(initial=0))


# ---------------------------------------------------------------------------
# per-run policy state: config + per-job derived columns
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Policy:
    """A ``PolicyConfig`` bound to a job schedule.

    The per-job columns are derived once, on the host, in the dtypes both
    drivers share (``slack`` int64, ``thresh``/``value`` float32,
    ``deadline_ep`` int64), so every threshold comparison and priority
    sort sees identical constants on the host and scan paths."""
    cfg: PolicyConfig
    slack: np.ndarray        # (J,) max start delay in epochs (0 = none)
    thresh: np.ndarray       # (J,) f32 per-job green threshold factor
    value: np.ndarray        # (J,) f32 queue-priority value
    deadline_ep: np.ndarray  # (J,) arrive + slack (latest start epoch)

    @classmethod
    def for_jobs(cls, pcfg: PolicyConfig, arrive: np.ndarray,
                 deferrable: np.ndarray, defer_max_h: int,
                 deadline: Optional[np.ndarray] = None,
                 value: Optional[np.ndarray] = None) -> "Policy":
        arrive = np.asarray(arrive, np.int64)
        deferrable = np.asarray(deferrable, bool)
        J = arrive.shape[0]
        if deadline is None:
            slack = np.where(deferrable, defer_max_h, 0).astype(np.int64)
        else:
            slack = np.where(deferrable, np.asarray(deadline, np.int64), 0)
        value32 = np.ones(J, np.float32) if value is None \
            else np.asarray(value, np.float32)
        if pcfg.deferral == "slo":
            thresh = (pcfg.defer_green_factor
                      * np.exp(-pcfg.value_weight * value32.astype(
                          np.float64))).astype(np.float32)
        else:
            thresh = np.full(J, pcfg.defer_green_factor, np.float32)
        return cls(cfg=pcfg, slack=slack, thresh=thresh, value=value32,
                   deadline_ep=arrive + slack)

    # -- driver-facing predicates ------------------------------------------

    @property
    def lookahead(self) -> bool:
        return self.cfg.migration == "lookahead"

    @property
    def slo(self) -> bool:
        return self.cfg.deferral == "slo"

    def defer_window(self, defer_max_h: int) -> int:
        """Forecast window (hours) the deferral green signal scans.
        Reactive keeps the historical ``defer_max_h`` (static-graph
        parity); SLO widens to the largest per-job slack.  Clamped to one
        hour: a zero-width window would make the signal an empty-axis
        min (historically a crash at ``defer_max_h=0``), while at zero
        slack no job can defer regardless of the signal."""
        if not self.slo:
            return max(defer_max_h, 1)
        return max(int(self.slack.max(initial=0)), 1)

    def queue_cap(self, epochs: int) -> int:
        """Static SLO queue capacity: the configured cap, else a sound
        occupancy bound so admission never overflows."""
        if self.cfg.queue_cap > 0:
            return self.cfg.queue_cap
        return sound_queue_bound(self.deadline_ep - self.slack, self.slack,
                                 epochs)
