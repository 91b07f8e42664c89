"""Sub-epoch serving traffic: seeded fleet-QPS streams for the simulator
(the port's own copy of ``repro.core.traffic``: numpy only, so a plan is
byte-identical to the reference's for the same ``(tcfg, sim_seed)``).

MAIZX ranks resources for *workloads*, but a production fleet also serves
*requests*: millions of queries whose volume follows the day and spikes on
flash crowds, and whose latency is bounded by an SLO.  This module
materializes ONE seeded :class:`TrafficPlan` — a per-epoch request-count
tensor ``(T,)`` — that every simulator driver consumes: the scanned
driver and the ensemble upload it to the device once per run and index it
per epoch there, and the host loop indexes the identical array per epoch,
so routing decisions stay bit-identical across drivers (see
``repro_torch.core.router`` for the split itself).

Stream recipe mirrors ``core.faults``: per-class seed-stream tags feed
``np.random.default_rng([stream, cfg-seed, sim-seed])`` so enabling one
stream never perturbs another, and all *rates* are data, not graph
structure — a (QPS x SLO x greenness) grid shares one ensemble bucket
(only :func:`traffic_graph_key` shapes the trajectory).  A ``req_rate ==
0`` config materializes an all-zero request stream which is an exact no-op
for every driver: placements and emissions reproduce the traffic-free
golden trajectories bit-for-bit.

Request counts are quantized to integers (one "request" may stand for an
aggregated batch of real queries): integer demand is what makes the
router's water-fill bit-exact across numpy and torch — int32 splits have
no rounding to disagree on.  Counts are capped at :data:`REQ_CAP` per epoch
and per-job QPS weights must sum below :data:`WEIGHT_SUM_CAP` so the
int32 weight-share product in the router cannot overflow.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["TrafficConfig", "TrafficPlan", "REQ_CAP", "WEIGHT_SUM_CAP",
           "plan_traffic", "traffic_graph_key", "validate_qps_weights"]

# per-class seed-stream tags, continuing the faults.py prime series
_S_QPS, _S_FLASH = 29, 31

#: Per-epoch request-count ceiling: keeps ``req * weight_sum`` inside
#: int32 for the router's weight-share split (65535 * 32767 < 2^31).
REQ_CAP = (1 << 16) - 1
#: Fleet-wide ``qps_weight`` sum ceiling (same int32-overflow argument).
WEIGHT_SUM_CAP = (1 << 15) - 1


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Hashable traffic knobs.  Everything except ``n_svc`` (which shapes
    the router's per-service bins) reaches the trajectory as data."""
    seed: int = 0
    # --- offered load (requests per epoch) ---
    req_rate: float = 0.0          # mean requests/epoch; 0 = serving off
    diurnal_amp: float = 0.4       # business-hours modulation amplitude
    noise_sigma: float = 0.0       # lognormal jitter on the hourly rate
    # --- flash crowds (seeded windows, drawn regardless of rate: CRN) ---
    flash_rate: float = 0.0        # P[flash crowd starts] per epoch
    flash_len_h: int = 3           # mean crowd length (geometric)
    flash_mult: float = 2.5        # rate multiplier inside a crowd
    # --- service topology / per-replica queueing ---
    n_svc: int = 1                 # independent services sharing the fleet
    serve_frac: float = 0.5        # fraction of jobs that are replicas
    weight_hi: int = 4             # qps_weight ~ U{1..weight_hi}
    mu_per_chip: float = 2.0       # per-chip service rate, requests/s

    def __post_init__(self):
        for f in ("flash_rate", "serve_frac"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.req_rate < 0.0:
            raise ValueError(f"req_rate must be >= 0, got {self.req_rate}")
        if self.n_svc < 0:
            raise ValueError(f"n_svc must be >= 0, got {self.n_svc}")
        if self.weight_hi < 1:
            raise ValueError(f"weight_hi must be >= 1, got {self.weight_hi}")
        if self.mu_per_chip <= 0.0:
            raise ValueError(
                f"mu_per_chip must be > 0, got {self.mu_per_chip}")


def traffic_graph_key(tcfg: Optional[TrafficConfig]) -> int:
    """The ONLY traffic knob that shapes the scanned trajectory: the
    service count (0 = serving layer off entirely — no extra per-epoch
    inputs or outputs).  Rates, SLO, greenness and ``mu`` all reach it as
    per-lane data, so a whole (QPS x SLO x greenness) grid shares one
    ensemble bucket — the same canonicalization discipline as
    ``PolicyConfig.graph_key`` and ``faults.fault_graph_key``."""
    if tcfg is None:
        return 0
    return int(tcfg.n_svc)


@dataclasses.dataclass
class TrafficPlan:
    """Materialized request stream for one trajectory (host numpy; the
    scanned driver uploads it to the device once per run)."""
    req: np.ndarray      # (T,) int32 fleet requests per epoch, <= REQ_CAP
    rate: np.ndarray     # (T,) f64 underlying modulated rate (reference)


def _rng(stream: int, tcfg: TrafficConfig,
         sim_seed: int) -> np.random.Generator:
    return np.random.default_rng([stream, int(tcfg.seed) & 0x7FFFFFFF,
                                  int(sim_seed) & 0x7FFFFFFF])


def plan_traffic(tcfg: TrafficConfig, epochs: int,
                 sim_seed: int = 0) -> TrafficPlan:
    """Materialize the fleet request stream for one trajectory.

    Rate recipe mirrors ``simulator.generate_jobs``'s arrival process —
    diurnal cosine modulation, seeded flash-crowd windows, optional
    lognormal jitter — but on its own seed streams so enabling serving
    never perturbs the job schedule.  ``req_rate == 0`` yields an exact
    all-zero stream (the Poisson of rate 0 is 0 with probability 1)."""
    T = int(epochs)
    t = np.arange(T)
    rate = np.full(T, float(tcfg.req_rate))
    if tcfg.diurnal_amp != 0.0:
        rate *= 1.0 + tcfg.diurnal_amp * np.cos(
            2 * np.pi * (t % 24 - 14) / 24)
    rng = _rng(_S_QPS, tcfg, sim_seed)
    # jitter drawn regardless of sigma (CRN across sigma grids); sigma=0
    # multiplies by exp(0)=1.0 exactly (bitwise no-op)
    z = rng.standard_normal(T)
    rate *= np.exp(tcfg.noise_sigma * z)
    # flash crowds: start uniforms + geometric lengths drawn regardless of
    # flash_rate, so a rate grid censors a shared window history
    rng_f = _rng(_S_FLASH, tcfg, sim_seed)
    u = rng_f.random(T)
    ln = rng_f.geometric(1.0 / max(float(tcfg.flash_len_h), 1.0), size=T)
    if tcfg.flash_rate > 0.0:
        for t0 in np.nonzero(u < tcfg.flash_rate)[0]:
            rate[t0:t0 + int(ln[t0])] *= tcfg.flash_mult
    req = rng.poisson(rate) if tcfg.req_rate > 0.0 \
        else np.zeros(T, np.int64)
    return TrafficPlan(req=np.minimum(req, REQ_CAP).astype(np.int32),
                       rate=rate)


def validate_qps_weights(qps_weight: Optional[np.ndarray]) -> None:
    """Raise if the schedule's QPS weights could overflow the router's
    int32 weight-share arithmetic.  Called by every simulator driver at
    setup (config validation on the host)."""
    if qps_weight is None:
        raise ValueError(
            "SimConfig.traffic with n_svc > 0 requires JobSchedule "
            "qps_weight/svc_class columns (generate_jobs draws them when "
            "a TrafficConfig is set)")
    total = int(np.asarray(qps_weight, np.int64).sum())
    if total > WEIGHT_SUM_CAP:
        raise ValueError(
            f"sum of qps_weight ({total}) exceeds WEIGHT_SUM_CAP "
            f"({WEIGHT_SUM_CAP}); the router's int32 weight-share split "
            f"would overflow — lower TrafficConfig.weight_hi or "
            f"serve_frac, or shrink the schedule")
