"""Signal-fault injection: seeded fault streams for the fleet simulator
(the port's own copy of ``repro.core.faults``: numpy only, so a plan is
byte-identical to the reference's for the same ``(fcfg, sim_seed)``).

Every MAIZX input the simulator consumes is a signal that fails in
production: the carbon-intensity feed drops samples or goes stale, the
forecast service has outage windows, telemetry carries noise and bias,
hypervisor migration commands time out, and nodes flap.  This module
materializes ONE seeded ``FaultPlan`` — per-epoch fault tensors shaped
``(T, R)`` / ``(T,)`` / ``(T, N)`` — that BOTH simulator drivers consume:
the scanned driver (``simulate_fleet_scan`` / ``simulate_fleet_ensemble``)
uploads them to the device once per run and indexes them per epoch there,
and the host loop indexes the identical arrays per epoch, so placements
stay bit-identical under every fault stream.

Fault classes (all rates are data, not trajectory structure — grids over
rates share one ensemble bucket; see ``fault_graph_key``):

- **CI-feed dropout + staleness** (``ci_dropout``): each (epoch, region)
  sample is independently missing.  The *observed* trace holds the last
  value while ``staleness <= stale_cap_h``; past the cap the degraded
  reading falls back to persistence-of-day — replaying the last fully
  observed 24 h at the same hour-of-day (``stale_cap_h = 0`` disables the
  cap: trust-stale-forever, the *naive* operator).  Decisions read the
  observed trace; emission accounting always reads ground truth.
- **Telemetry noise/bias** (``telem_sigma`` / ``telem_bias``): fresh
  samples are scaled by ``(1 + bias) * exp(sigma * z)`` — multiplicative
  lognormal sensor error.  Zero rates multiply by exactly 1.0 (bitwise
  no-op).
- **Forecast-service outages** (``fc_outage`` windows + ``fc_dropout``):
  epochs where ``fit_forecast`` is unavailable; the degraded path
  substitutes ``forecast.persistence_forecast`` over the same observed
  window.
- **Migration-actuation failures** (``mig_fail``): each of the epoch's
  ``migration_budget`` attempt ranks independently fails.  A failed
  attempt consumes its budget slot (the hypervisor command was issued),
  the job stays put, and retry is blocked for
  ``mig_backoff_h * 2**(fails-1)`` epochs (exponential backoff, reset on
  a later success).
- **Node flapping** (``flap_rate`` / ``flap_len_h``) + **quarantine**
  (``quarantine_h``): nodes go down for ~geometric spells beyond the
  scheduled ``SimConfig.outage`` windows; a flapped node must be healthy
  ``quarantine_h`` consecutive hours before placement re-eligibility.
- **Safe mode** (``safe_stale_h``): when even the *freshest* node-bearing
  region's CI is staler than the horizon, the degraded policy freezes
  migrations and green-window deferral (acting on garbage is worse than
  holding still) until signal returns.

Random streams are independent per fault class and nested across rates
(common random numbers): two configs differing only in a rate share the
underlying uniforms, so a degradation curve over ``ci_dropout`` compares
the SAME fault history at increasing censoring — the curve is monotone by
construction, not by luck.  A zero-rate ``FaultConfig`` materializes
tensors that are exact no-ops, and ``simulate_fleet*`` with
``faults=None`` never builds a plan at all — both reproduce the fault-free
golden trajectories bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["FaultConfig", "FaultPlan", "fault_graph_key", "plan_faults"]

# per-class seed-stream tags: enabling one fault class never perturbs the
# draws of another, and rates within a class censor a shared uniform grid
_S_CI, _S_TELEM, _S_FC, _S_FLAP, _S_MIG = 11, 13, 17, 19, 23


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Hashable fault knobs.  Environment knobs (what breaks) and
    degradation knobs (how the operator responds) live together so one
    config describes one run; a *naive* operator is the same environment
    with ``stale_cap_h = quarantine_h = safe_stale_h = 0`` and
    ``mig_backoff_h = 1``."""
    seed: int = 0
    # --- CI feed (per epoch x region) ---
    ci_dropout: float = 0.0        # P[sample missing]
    stale_cap_h: int = 0           # hold-last cap; 0 = trust stale forever
    telem_sigma: float = 0.0       # lognormal noise on fresh samples
    telem_bias: float = 0.0        # multiplicative sensor bias
    # --- forecast service (per epoch) ---
    fc_outage: Tuple[Tuple[int, int], ...] = ()   # ((t0, len), ...)
    fc_dropout: float = 0.0
    # --- migration actuation (per epoch x budget rank) ---
    mig_fail: float = 0.0
    mig_backoff_h: int = 2         # base retry backoff after a failure
    # --- node flapping (per epoch x node) ---
    flap_rate: float = 0.0         # P[flap starts] per node-epoch
    flap_len_h: int = 2            # mean down-spell length (geometric)
    quarantine_h: int = 0          # healthy hours required before re-use
    # --- safe mode ---
    safe_stale_h: int = 0          # freeze policy when ALL regions staler

    def __post_init__(self):
        for f in ("ci_dropout", "fc_dropout", "mig_fail", "flap_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        for t0, ln in self.fc_outage:
            if ln < 0 or t0 < 0:
                raise ValueError(
                    f"fc_outage windows are (t0 >= 0, len >= 0), got "
                    f"({t0}, {ln})")


def fault_graph_key(fcfg: Optional[FaultConfig]) -> tuple:
    """``(present, mig_failures, flaps)`` — the ONLY fault knobs that
    shape the scanned trajectory (extra carries and per-epoch inputs).
    Every rate, cap and backoff reaches it as data or a per-run scalar, so
    a whole degradation grid — dropout rates, staleness caps, quarantines,
    naive vs degraded operators — shares one ensemble bucket (the same
    canonicalization discipline as ``PolicyConfig.graph_key``)."""
    if fcfg is None:
        return (False, False, False)
    return (True, fcfg.mig_fail > 0.0, fcfg.flap_rate > 0.0)


@dataclasses.dataclass
class FaultPlan:
    """Materialized fault streams for one trajectory (host numpy; the
    scanned driver uploads them to the device once per run)."""
    obs_traces: np.ndarray   # (R, H) f64 degraded observed CI (true warmup)
    stale: np.ndarray        # (T, R) i32 hours since last fresh sample
    fc_ok: np.ndarray        # (T,) forecast service available
    safe: np.ndarray         # (T,) safe mode active (policy freeze)
    node_up: np.ndarray      # (T, N) raw flap state
    eligible: np.ndarray     # (T, N) up AND quarantine served
    mig_fail: np.ndarray     # (T, B) actuation failure per attempt rank

    @property
    def has_flaps(self) -> bool:
        return bool((~self.eligible).any())

    @property
    def has_migfail(self) -> bool:
        return bool(self.mig_fail.any())


def _rng(stream: int, fcfg: FaultConfig, sim_seed: int
         ) -> np.random.Generator:
    return np.random.default_rng([stream, int(fcfg.seed) & 0x7FFFFFFF,
                                  int(sim_seed) & 0x7FFFFFFF])


def plan_faults(fcfg: FaultConfig, region_ci: np.ndarray, ridx: np.ndarray,
                epochs: int, history_h: int, budget: int, n_nodes: int,
                sim_seed: int = 0) -> FaultPlan:
    """Materialize every fault stream for one trajectory.

    ``region_ci`` is the true ``(R, history_h + epochs + margin)`` trace;
    the observed copy degrades only the in-horizon columns
    ``[history_h, history_h + epochs)`` — warmup history is assumed
    archived (fault-free), so the forecaster's window degrades gradually
    as stale epochs enter it, exactly as a real feed would."""
    T, R, N = int(epochs), region_ci.shape[0], int(n_nodes)
    B = max(int(budget), 0)

    # --- CI feed: dropout mask + staleness + degraded observed trace ----
    u_ci = _rng(_S_CI, fcfg, sim_seed).random((T, R))
    fresh = u_ci >= fcfg.ci_dropout                 # CRN across rates
    z = _rng(_S_TELEM, fcfg, sim_seed).standard_normal((T, R))
    factor = (1.0 + fcfg.telem_bias) * np.exp(fcfg.telem_sigma * z)
    obs = np.array(region_ci, np.float64, copy=True)
    stale = np.zeros((T, R), np.int32)
    cap = int(fcfg.stale_cap_h)
    for r in range(R):
        s = 0
        for t in range(T):
            a = history_h + t
            if fresh[t, r]:
                s = 0
                obs[r, a] = region_ci[r, a] * factor[t, r]
            else:
                s += 1
                if 0 < cap < s and a - s + 1 >= 24:
                    # persistence-of-day: replay the last observed day at
                    # the same hour offset (af = column of last fresh
                    # sample; d hours past it reads af+1+((d-1)%24) - 24)
                    obs[r, a] = obs[r, a - s + 1 + (s - 1) % 24 - 24]
                else:
                    obs[r, a] = obs[r, a - 1]       # hold last value
            stale[t, r] = s

    # --- forecast service availability ----------------------------------
    fc_ok = _rng(_S_FC, fcfg, sim_seed).random(T) >= fcfg.fc_dropout
    for t0, ln in fcfg.fc_outage:
        fc_ok[t0:t0 + ln] = False

    # --- safe mode: even the freshest node-bearing region is stale ------
    safe = np.zeros(T, bool)
    if fcfg.safe_stale_h > 0:
        node_regions = np.unique(np.asarray(ridx, np.int64))
        safe = stale[:, node_regions].min(axis=1) > fcfg.safe_stale_h

    # --- node flapping + quarantine re-admission ------------------------
    rng_f = _rng(_S_FLAP, fcfg, sim_seed)
    u_flap = rng_f.random((T, N))
    spell = rng_f.geometric(1.0 / max(float(fcfg.flap_len_h), 1.0),
                            size=(T, N))            # drawn regardless of
    up = np.ones((T, N), bool)                      # rate (CRN)
    if fcfg.flap_rate > 0.0:
        for t, n in zip(*np.nonzero(u_flap < fcfg.flap_rate)):
            up[t:t + int(spell[t, n]), n] = False
    eligible = up.copy()
    H = int(fcfg.quarantine_h)
    if H > 0 and not up.all():
        down = ~up
        for t in range(T):
            eligible[t] &= ~down[max(t - H, 0):t].any(axis=0)

    # --- migration-actuation failures per attempt rank ------------------
    mig = _rng(_S_MIG, fcfg, sim_seed).random((T, B)) < fcfg.mig_fail

    return FaultPlan(obs_traces=obs, stale=stale, fc_ok=fc_ok, safe=safe,
                     node_up=up, eligible=eligible, mig_fail=mig)
